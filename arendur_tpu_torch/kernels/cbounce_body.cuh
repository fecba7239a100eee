// The bounce body (see cbounce.cuh), written over the scalar type F and
// the table-row type Row of the enclosing namespace.  Not a header of
// its own: cbounce.cuh includes it in namespace cbounce (F = float, the
// forward kernel K3) and cbounce_ad.cuh in namespace cbounce_ad
// (F = ad::R, the backward kernel K4).  Where the PyTorch body detaches
// a sampled quantity (a light sample point, a BSDF sample direction) it
// is computed here on values with the float routines of cmath and
// enters as a constant (vconst), so the backward gets no gradient
// through it, as autograd does not.

// ---------------------------------------------------------------------------
// geometry twins
// ---------------------------------------------------------------------------

HDB void bary_from_vertices(V3 o, V3 d, V3 v0, V3 v1, V3 v2, F* b0,
                           F* b1) {
  V3 e1 = vsub(v1, v0);
  V3 e2 = vsub(v2, v0);
  V3 pvec = vcross(d, e2);
  F det = vdot(e1, pvec);
  F inv = 1.0f / (fabsf(det) > 1e-20f ? det : 1.0f);
  V3 tvec = vsub(o, v0);
  F u = vdot(tvec, pvec) * inv;
  F v = vdot(d, vcross(tvec, e1)) * inv;
  *b0 = 1.0f - u - v;
  *b1 = u;
}

HDB void tri_dpduv(V3 v0, V3 v1, V3 v2, F u0, F w0, F u1,
                  F w1, F u2, F w2, V3* dpdu_, V3* dpdv_) {
  F d02u = u0 - u2, d02v = w0 - w2;
  F d12u = u1 - u2, d12v = w1 - w2;
  V3 dp02 = vsub(v0, v2);
  V3 dp12 = vsub(v1, v2);
  F det = d02u * d12v - d02v * d12u;
  bool ok = det != 0.0f;
  F inv = 1.0f / (ok ? det : 1.0f);
  V3 dpdu = vscale(vsub(vscale(dp02, d12v), vscale(dp12, d02v)), inv);
  V3 dpdv = vscale(vadd(vscale(dp02, -d12u), vscale(dp12, d02u)), inv);
  V3 ng = vcross(dp02, vsub(v0, v1));
  V3 fb_u = vnormalize(dp02);
  V3 fb_v = vnormalize(vcross(ng, dp02));
  *dpdu_ = ok ? dpdu : fb_u;
  *dpdv_ = ok ? dpdv : fb_v;
}

HDB void sphere_shading_from_row(Row s, V3 p, V3* pos_, V3* ng_,
                                V3* dpdu_, V3* dpdv_, V3* perr_) {
  F radius = s[16], thetamin = s[17], thetamax = s[18], phimax = s[19];
  F thetadelta = thetamax - thetamin;
  F theta = acos_poly(clampf_(p.z / mx(radius, 1e-20f),
                                  (float)(-1.0 + 1e-7), (float)(1.0 - 1e-7)));
  F inv_zr = 1.0f / sqrtf(mx(p.x * p.x + p.y * p.y, 1e-30f));
  F cphi = p.x * inv_zr;
  F sphi = p.y * inv_zr;
  V3 dpdu_l = v3(-phimax * p.y, phimax * p.x, 0.0f);
  V3 dpdv_l = vscale(v3(p.z * cphi, p.z * sphi, -radius * sinf(theta)),
                     thetadelta);
  V3 pos = tp16(s, p);
  V3 dpdu = tv16(s, dpdu_l);
  V3 dpdv = tv16(s, dpdv_l);
  *ng_ = vnormalize(vcross(dpdu, dpdv));
  *pos_ = pos;
  *dpdu_ = dpdu;
  *dpdv_ = dpdv;
  *perr_ = vscale(vabs(pos), (float)(5.0 * 0x1p-24));
}

HDB V3 offset_ray_origin(V3 pos, V3 perr, V3 n, V3 d) {
  F edn = fabsf(n.x) * perr.x + fabsf(n.y) * perr.y + fabsf(n.z) * perr.z;
  F s = vdot(d, n) <= 0.0f ? -edn : edn;
  F pc[3] = {pos.x, pos.y, pos.z};
  F nc[3] = {n.x, n.y, n.z};
  F out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    F off = s * nc[c];
    F p = pc[c] + off;
    out[c] = off > 0.0f ? nextafterf(p, INFINITY)
                        : (off < 0.0f ? nextafterf(p, -INFINITY) : p);
  }
  return v3(out[0], out[1], out[2]);
}

// ---------------------------------------------------------------------------
// NEE twins
// ---------------------------------------------------------------------------

struct LightSample {
  V3 radiance, pfrom, wi;
  F pdf;
  bool delta;
};

HDB LightSample light_sample_rows(Row lr, const ShadeCfg& cfg,
                                 V3 pos, float u0, float u1) {
  int lt = (int)rawf(lr, cfg.c_ltype);
  V3 emission = ld3(lr, cfg.c_emission);
  V3 pfrom = vzero(), radiance = vzero();
  F pdf = 0.0f;
  bool known = lt >= 0 && lt <= 4 && has_l(cfg, lt);
  if (known && lt == L_AREA_SPHERE) {
    Row w2o = lr + cfg.c_s_w2o;
    Row o2w = lr + cfg.c_s_o2w;
    V3 pos_local = tp16(w2o, pos);
    F radius = lr[cfg.c_s_radius], zmin = lr[cfg.c_s_zmin],
          zmax = lr[cfg.c_s_zmax], thetamin = lr[cfg.c_s_thetamin],
          thetamax = lr[cfg.c_s_thetamax], phimax = lr[cfg.c_s_phimax];
    // the sampled point on the sphere is detached
    float phi = u0 * val(phimax);
    float theta;
    if (cfg.theta_compat) {
      theta = u1 * (val(thetamax) - val(thetamin)) + val(thetamin);
    } else {
      float z = val(zmin) / val(radius) +
                u1 * (val(zmax) - val(zmin)) / val(radius);
      theta = cmath::acos_poly(
          cmath::clampf_(z, (float)(-1.0 + 1e-7), (float)(1.0 - 1e-7)));
    }
    float st = sinf(theta);
    cmath::V3 ln_f = cmath::v3(st * cosf(phi), st * sinf(phi), cosf(theta));
    V3 ln_l = vconst(ln_f);
    V3 lp_l = vconst(cmath::vscale(ln_f, val(radius)));
    F area = phimax * radius * (zmax - zmin);
    F pdf_area = 1.0f / area;
    V3 wi_l = vsub(lp_l, pos_local);
    F d2 = vlength2(wi_l);
    V3 wi_ln = vscale(wi_l, rsqrtf(mx(d2, 1e-20f)));
    F denom = fabsf(vdot(ln_l, wi_ln));
    F inv_den = denom > 1e-20f ? 1.0f / mx(denom, 1e-20f) : 0.0f;
    pdf = pdf_area * d2 * inv_den;
    pdf = (d2 < 1e-12f || !fin(pdf)) ? 0.0f : pdf;
    bool front = vdot(vsub(pos_local, lp_l), ln_l) > 0.0f;
    pfrom = tp16(o2w, lp_l);
    radiance = front ? emission : vzero();
  } else if (known && lt == L_AREA_TRI) {
    if (cfg.c_tri_v0 >= 0) {
      V3 bary = vconst(cmath::sample_uniform_triangle(u0, u1));
      V3 v0 = ld3(lr, cfg.c_tri_v0), v1 = ld3(lr, cfg.c_tri_v1),
         v2 = ld3(lr, cfg.c_tri_v2);
      V3 n0 = ld3(lr, cfg.c_tri_n0), n1 = ld3(lr, cfg.c_tri_n1),
         n2 = ld3(lr, cfg.c_tri_n2);
      V3 lp = vadd(vadd(vscale(v0, bary.x), vscale(v1, bary.y)),
                   vscale(v2, bary.z));
      V3 ln = vnormalize(vadd(vadd(vscale(n0, bary.x), vscale(n1, bary.y)),
                              vscale(n2, bary.z)));
      F area = 0.5f * sqrtf(mx(vlength2(vcross(vsub(v1, v0),
                                                     vsub(v2, v0))), 1e-30f));
      F pdf_area = 1.0f / area;
      V3 wi_t = vsub(lp, pos);
      F d2 = vlength2(wi_t);
      V3 wi_tn = vscale(wi_t, rsqrtf(mx(d2, 1e-20f)));
      F denom = fabsf(vdot(ln, wi_tn));
      F inv_den = denom > 1e-20f ? 1.0f / mx(denom, 1e-20f) : 0.0f;
      pdf = pdf_area * d2 * inv_den;
      pdf = (d2 < 1e-12f || !fin(pdf)) ? 0.0f : pdf;
      bool front = vdot(vsub(pos, lp), ln) > 0.0f;
      pfrom = lp;
      radiance = front ? emission : vzero();
    }
  } else if (known && (lt == L_POINT || lt == L_SPOT)) {
    V3 lpos = ld3(lr, cfg.c_pos);
    V3 wi_p = vsub(lpos, pos);
    F d2 = vlength2(wi_p);
    V3 rad_p = vscale(emission, 1.0f / mx(d2, 1e-20f));
    pfrom = lpos;
    pdf = 1.0f;
    if (lt == L_POINT) {
      radiance = rad_p;
    } else {
      V3 axis = vnormalize(ld3(lr, cfg.c_aux));
      F cos_total = lr[cfg.c_params];
      F cos_falloff = lr[cfg.c_params + 1];
      V3 wi_pn = vscale(wi_p, rsqrtf(mx(d2, 1e-20f)));
      F cos_to = vdot(vneg(wi_pn), axis);
      F tt = clampf_((cos_to - cos_total) /
                             mx(cos_falloff - cos_total, 1e-8f),
                         0.0f, 1.0f);
      F falloff = cos_to < cos_total
                          ? 0.0f
                          : (cos_to > cos_falloff ? 1.0f : (tt * tt) * (tt * tt));
      radiance = vscale(rad_p, falloff);
    }
  } else if (known && lt == L_DISTANT) {
    V3 ldir = vnormalize(ld3(lr, cfg.c_pos));
    F wr = lr[cfg.c_params];
    pfrom = vsub(pos, vscale(ldir, 2.0f * mx(wr, 1e-6f)));
    radiance = emission;
    pdf = 1.0f;
  }
  LightSample ls;
  ls.pfrom = pfrom;
  ls.radiance = radiance;
  ls.pdf = pdf;
  ls.wi = vnormalize(vsub(pfrom, pos));
  bool any_delta = has_l(cfg, L_POINT) || has_l(cfg, L_SPOT);
  ls.delta = any_delta && (lt == L_POINT || lt == L_SPOT);
  return ls;
}

HD V3 refine_p_local(V3 o, V3 d, F t, F radius) {
  V3 p = vadd(o, vscale(d, t));
  F plen = sqrtf(mx(vlength2(p), 0.0f));
  p = vscale(p, radius / mx(plen, 1e-20f));
  bool degenerate = (p.x == 0.0f) && (p.y == 0.0f);
  return v3(degenerate ? 1e-5f * radius : p.x, p.y, p.z);
}

// (the intersect kernels K1 / K2 also read the root t through t_out)
HDB bool intersect_local_sphere(V3 o, V3 d, F tmax, F radius,
                               F zmin, F zmax, F phimax,
                               bool skip_phi_clip, V3* p_out,
                               F* t_out = nullptr) {
  F a = mx(vdot(d, d), 1e-20f);
  F b = 2.0f * vdot(d, o);
  F c = vdot(o, o) - radius * radius;
  F delta = b * b - 4.0f * a * c;
  bool has_root = delta >= 0.0f;
  F sq = sqrtf(mx(delta, 1e-30f));
  F inv2a = 1.0f / (2.0f * a);
  F d1 = sq * inv2a;
  F d0 = -b * inv2a;
  F t0 = d0 - d1;
  F t1 = d0 + d1;
  F t = t0 > 0.0f ? t0 : t1;
  bool ok = has_root && !((t0 > tmax) || (t1 < 0.0f)) &&
            !((t0 <= 0.0f) && (t1 > tmax));
  V3 p = refine_p_local(o, d, t, radius);
  bool clipped = (p.z < zmin) || (p.z > zmax);
  if (!skip_phi_clip) {
    float phi = cmath::atan2_poly(val(p.y), val(p.x));
    phi = phi < 0.0f ? phi + (float)(2.0 * PI_D) : phi;
    clipped = clipped || (phi > phimax);
  }
  *p_out = p;
  if (t_out) *t_out = t;
  return ok && !clipped;
}

// num / den where hit and the ratio is finite, else 0; the division is
// taken only where it is kept (render/cbounce.py _masked_ratio)
HD F masked_ratio(bool hit, F num, F den) {
  bool ok = hit && fin(val(num) / val(den));
  return ok ? num / den : F(0.0f);
}

HDB F light_pdf_wi_rows(Row lr, const ShadeCfg& cfg, V3 pos,
                           V3 wi) {
  int lt = (int)rawf(lr, cfg.c_ltype);
  if (lt == L_AREA_SPHERE && has_l(cfg, L_AREA_SPHERE)) {
    Row w2o = lr + cfg.c_s_w2o;
    V3 pos_l = tp16(w2o, pos);
    V3 wi_l = tv16(w2o, wi);
    F radius = lr[cfg.c_s_radius];
    F zmin = lr[cfg.c_s_zmin], zmax = lr[cfg.c_s_zmax],
          phimax = lr[cfg.c_s_phimax];
    V3 p_l;
    bool hit = intersect_local_sphere(pos_l, wi_l, INFINITY, radius, zmin,
                                      zmax, phimax, cfg.full_phi != 0, &p_l);
    V3 n_l = vscale(p_l, rsqrtf(mx(vlength2(p_l), 1e-20f)));
    F area = phimax * radius * (zmax - zmin);
    F d2 = vlength2(vsub(p_l, pos_l));
    return masked_ratio(hit, d2, mx(fabsf(vdot(wi_l, n_l)), 1e-20f) * area);
  }
  if (lt == L_AREA_TRI && has_l(cfg, L_AREA_TRI) && cfg.c_tri_v0 >= 0) {
    V3 v0 = ld3(lr, cfg.c_tri_v0), v1 = ld3(lr, cfg.c_tri_v1),
       v2 = ld3(lr, cfg.c_tri_v2);
    V3 e1 = vsub(v1, v0);
    V3 e2 = vsub(v2, v0);
    V3 pvec = vcross(wi, e2);
    F det = vdot(e1, pvec);
    bool ok = fabsf(det) > 1e-12f;
    F inv = 1.0f / (ok ? det : 1.0f);
    V3 tvec = vsub(pos, v0);
    F u = vdot(tvec, pvec) * inv;
    V3 qvec = vcross(tvec, e1);
    F v = vdot(wi, qvec) * inv;
    F t = vdot(e2, qvec) * inv;
    bool hit = ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
               (t > 1e-6f);
    t = hit ? t : INFINITY;
    V3 ng = vnormalize(vcross(e1, e2));
    F area = 0.5f * sqrtf(mx(vlength2(vcross(e1, e2)), 1e-30f));
    F d2 = t * t;
    return masked_ratio(hit, d2, mx(fabsf(vdot(wi, ng)), 1e-20f) * area);
  }
  return 0.0f;
}

HDB void direct_light_contrib(const LightSample& ls, V3 f_raw, F spdf,
                             V3 ns, V3* contrib_, bool* need_shadow_) {
  bool no_effect = (ls.pdf == 0.0f) || is_black(ls.radiance);
  V3 f = vscale(f_raw, fabsf(vdot(ls.wi, ns)));
  f = spdf == 0.0f ? vzero() : f;
  bool need_shadow = !no_effect && !is_black(f);
  F inv_lpdf = ls.pdf > 1e-18f ? 1.0f / mx(ls.pdf, 1e-18f) : 0.0f;
  F w_mis = power_heuristic(ls.pdf, spdf);
  V3 contrib_delta = vscale(vmul(ls.radiance, f), inv_lpdf);
  V3 contrib_area = vscale(contrib_delta, w_mis);
  V3 contrib = ls.delta ? contrib_delta : contrib_area;
  contrib = (need_shadow && !no_effect) ? contrib : vzero();
  *contrib_ = sanitize(contrib);
  *need_shadow_ = need_shadow;
}

HDB F path_mis_weight_rows(Row lr, const ShadeCfg& cfg,
                              F selpdf, V3 pos, V3 wi2, F pdf2,
                              int kind2, V3 f2) {
  int lt = (int)rawf(lr, cfg.c_ltype);
  bool is_spec = (kind2 & SPECULAR) != 0;
  F lpdf = light_pdf_wi_rows(lr, cfg, pos, wi2);
  bool any_delta = has_l(cfg, L_POINT) || has_l(cfg, L_SPOT);
  bool delta = any_delta && (lt == L_POINT || lt == L_SPOT);
  bool active = !delta && !is_black(f2) && (pdf2 > 0.0f) &&
                (is_spec || (lpdf > 0.0f));
  F w2 = is_spec ? 1.0f : power_heuristic(pdf2, lpdf);
  return active ? w2 / mx(selpdf, 1e-20f) : 0.0f;
}

// ---------------------------------------------------------------------------
// slot-table BSDF
// ---------------------------------------------------------------------------

// A slot chosen at run time is read through slot_at, whose pick3 (the
// including namespace's) keeps the forward's slot arrays in registers;
// the loops over slots that evaluate one are SLOT_LOOPs.  The sweeps
// (match_count, bsdf_eval_pdf, bsdf_sample) take any B with the frame
// (ns ts bs ng), the slots' kinds (kind[k]) and a slot_at(b, k): a
// Slots here, or the slot sweeps' reader of a lane's BSDF in device
// memory (slot_shade.cuh LaneSlots).
struct Slots {
  V3 ns, ts, bs, ng;
  int type[MAX_SLOTS], kind[MAX_SLOTS], dist[MAX_SLOTS];
  V3 c0[MAX_SLOTS], c1[MAX_SLOTS];
  F p0[MAX_SLOTS], p1[MAX_SLOTS], p2[MAX_SLOTS];
};

// One slot's fields.
struct Slot {
  int type, kind, dist;
  V3 c0, c1;
  F p0, p1, p2;
};
HD Slot slot_at(const Slots& b, int k) {
  Slot s;
  s.type = pick3(b.type, k);
  s.kind = pick3(b.kind, k);
  s.dist = pick3(b.dist, k);
  s.c0 = pick3(b.c0, k);
  s.c1 = pick3(b.c1, k);
  s.p0 = pick3(b.p0, k);
  s.p1 = pick3(b.p1, k);
  s.p2 = pick3(b.p2, k);
  return s;
}

HDB void make_bsdf_frame(V3 ns, V3 dpdu, V3* t_, V3* b_) {
  V3 t = vsub(dpdu, vscale(ns, vdot(ns, dpdu)));
  bool bad = vlength2(t) < 1e-12f;
  V3 fb_u, fb_v;
  get_basis_from(ns, &fb_u, &fb_v);
  t = vnormalize(bad ? fb_u : t);
  *t_ = t;
  *b_ = vnormalize(vcross(ns, t));
}

HD V3 clip3(V3 c) {
  return v3(clampf_(c.x, 0.0f, 1.0f), clampf_(c.y, 0.0f, 1.0f),
            clampf_(c.z, 0.0f, 1.0f));
}

HD void put(Slots& b, int k, int stype, V3 c0, V3 c1, F p0, F p1,
            F p2, int dist) {
  b.type[k] = stype;
  b.c0[k] = c0;
  b.c1[k] = c1;
  b.p0[k] = p0;
  b.p1[k] = p1;
  b.p2[k] = p2;
  b.dist[k] = dist;
}

HDB Slots build_slots(int mtype, V3 kd, V3 ks, F sigma, F rough,
                     F eta, F dissolve, V3 ns, V3 ng, V3 dpdu) {
  Slots b;
#pragma unroll
  for (int k = 0; k < MAX_SLOTS; ++k)
    put(b, k, T_NONE, vzero(), vzero(), 0.0f, 0.0f, 0.0f, 0);
  F alpha = roughness_to_alpha(rough);
  F sigma_c = clampf_(sigma, 0.0f, 90.0f);
  bool kd_black = is_black(kd);
  bool ks_black = is_black(ks);
  V3 z = vzero();
  if (mtype == M_MATTE) {
    F s2 = sigma_c * sigma_c;
    F on_a = 1.0f - s2 / (2.0f * (s2 + 0.33f));
    F on_b = 0.45f * s2 / (s2 + 0.09f);
    if (!kd_black && sigma_c == 0.0f)
      put(b, 0, T_LAMBERT_R, kd, z, 0.0f, 0.0f, 0.0f, 0);
    else if (!kd_black && sigma_c != 0.0f)
      put(b, 0, T_OREN_NAYAR, kd, z, on_a, on_b, 0.0f, 0);
  } else if (mtype == M_PLASTIC) {
    put(b, 0, T_ASHIKHMIN, clip3(kd), clip3(ks), alpha, 0.0f, 0.0f,
        D_BECKMANN);
  } else if (mtype == M_GLASS) {
    bool g_spec = !ks_black;
    bool g_diff = !kd_black;
    if (g_spec) put(b, 0, T_FRESNEL_SPEC, ks, ks, 1.0f, eta, 0.0f, 0);
    if (g_diff && !g_spec) {
      put(b, 0, T_TS_R, kd, z, alpha, 1.0f, eta, D_TROWBRIDGE);
      put(b, 1, T_TS_T, kd, z, alpha, 1.0f, eta, D_TROWBRIDGE);
    }
    if (g_diff && g_spec) {
      put(b, 1, T_TS_R, kd, z, alpha, 1.0f, eta, D_TROWBRIDGE);
      put(b, 2, T_TS_T, kd, z, alpha, 1.0f, eta, D_TROWBRIDGE);
    }
  } else if (mtype == M_TRANSLUCENT) {
    bool t_as = dissolve != 0.0f;
    bool t_lt = !kd_black;
    if (t_as)
      put(b, 0, T_ASHIKHMIN, clip3(vscale(kd, dissolve)),
          clip3(vscale(ks, dissolve)), alpha, 0.0f, 0.0f, D_TROWBRIDGE);
    if (t_lt) {
      V3 c0 = vscale(kd, 1.0f - dissolve);
      if (t_as)
        put(b, 1, T_LAMBERT_T, c0, z, 0.0f, 0.0f, 0.0f, 0);
      else
        put(b, 0, T_LAMBERT_T, c0, z, 0.0f, 0.0f, 0.0f, 0);
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_SLOTS; ++k) b.kind[k] = kind_of_type(b.type[k]);
  b.ns = ns;
  b.ng = ng;
  make_bsdf_frame(ns, dpdu, &b.ts, &b.bs);
  return b;
}

template <class B>
HD int match_count(const B& b, int types) {
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < MAX_SLOTS; ++k) cnt += (b.kind[k] & types) != 0;
  return cnt;
}

HDB V3 oren_nayar_eval(V3 c0, F p0, F p1, V3 wo, V3 wi) {
  F sin_ti = sin_theta(wi);
  F sin_to = sin_theta(wo);
  F sin_pi_ = sin_phi(wi);
  F sin_po = sin_phi(wo);
  F cos_pi_ = cos_phi(wi);
  F cos_po = cos_phi(wo);
  F dcos = cos_pi_ * cos_po + sin_pi_ * sin_po;
  F max_cos = ((sin_ti > 1e-4f) || (sin_to > 1e-4f)) ? mx(dcos, 0.0f)
                                                          : 0.0f;
  F ci = fabsf(cos_theta(wi));
  F co = fabsf(cos_theta(wo));
  F sin_a = ci > co ? sin_to : sin_ti;
  F tan_b = mn(ci > co ? sin_ti / mx(ci, 1e-12f) : sin_to / mx(co, 1e-12f),
                   1e4f);
  F s = INV_PI * (p0 + p1 * max_cos * sin_a * tan_b);
  return vscale(c0, s);
}
HD F cos_pdf_same(V3 wo, V3 wi) {
  return wo.z * wi.z > 0.0f ? fabsf(cos_theta(wi)) * INV_PI : 0.0f;
}
HD F cos_pdf_opposite(V3 wo, V3 wi) {
  return wo.z * wi.z >= 0.0f ? 0.0f : fabsf(cos_theta(wi)) * INV_PI;
}
HD F fin_(F x) { return clampf_(x, -FMAX, FMAX); }

HDB V3 ts_r_eval(V3 c0, F alpha, F eta0, F eta1, int dist, V3 wo,
                V3 wi, int dists) {
  V3 wh = vnormalize(vadd(wo, wi));
  bool nanmask = !visfinite(wh);
  F d = mf_distribution(dist, wh, alpha, alpha, dists);
  F g = mf_visible_both(dist, wo, wi, alpha, alpha, dists);
  F fr = fresnel_dielectric(vdot(wi, wh), eta0, eta1);
  F denom = 4.0f * fabsf(wo.z) * fabsf(wi.z);
  F s = fin_(d * g * fr / mx(denom, 1e-20f));
  return nanmask ? vzero() : vscale(c0, s);
}

HDB V3 ts_t_eval(V3 c0, F alpha, F eta0, F eta1, int dist, V3 wo,
                V3 wi, int dists) {
  bool same_side = wo.z * wi.z > 0.0f;
  F eta = wo.z > 0.0f ? csafe_ratio(eta1, eta0) : csafe_ratio(eta0, eta1);
  V3 wh = vnormalize(vadd(wo, vscale(wi, eta)));
  bool wh_bad = !visfinite(wh);
  wh = wh.z < 0.0f ? vneg(wh) : wh;
  F cosoh = vdot(wo, wh);
  F fr = fresnel_dielectric(cosoh, eta0, eta1);
  F cosih = vdot(wi, wh);
  F sqrt_denom = cosoh + eta * cosih;
  F d = mf_distribution(dist, wh, alpha, alpha, dists);
  F g = mf_visible_both(dist, wo, wi, alpha, alpha, dists);
  F denom = fabsf(cos_theta(wo)) * fabsf(cos_theta(wi)) * sqrt_denom *
                sqrt_denom;
  F s = fin_(d * g * (1.0f - fr) * fabsf(cosih) * fabsf(cosoh) /
                 mx(denom, 1e-20f));
  V3 val = vscale(c0, s);
  val = wh_bad ? v3(1.0f, 1.0f, 1.0f) : val;
  return same_side ? vzero() : val;
}

HDB V3 ashikhmin_eval(V3 c0, V3 c1, F alpha, int dist, V3 wo, V3 wi,
                     int dists) {
  V3 wh_raw = vadd(wo, wi);
  bool degen = vlength2(wh_raw) < 1e-12f;
  V3 wh = vnormalize(degen ? v3(1.0f, 0.0f, 0.0f) : wh_raw);
  F term_o = 1.0f - powf(1.0f - 0.5f * fabsf(cos_theta(wo)), 5.0f);
  F term_i = 1.0f - powf(1.0f - 0.5f * fabsf(cos_theta(wi)), 5.0f);
  F dsc = (float)(28.0 / (23.0 * PI_D)) * (term_o * term_i);
  V3 diffuse = v3(c0.x * (1.0f - c1.x) * dsc, c0.y * (1.0f - c1.y) * dsc,
                  c0.z * (1.0f - c1.z) * dsc);
  F d = mf_distribution(dist, wh, alpha, alpha, dists);
  F cosih = vdot(wi, wh);
  F denom = 4.0f * fabsf(cosih) *
                mxx(fabsf(cos_theta(wi)), fabsf(cos_theta(wo)));
  F sd = fin_(d / mx(denom, 1e-20f));
  V3 sf = schlick_fresnel(cosih, c1);
  V3 spec = vscale(sf, sd);
  return degen ? vzero() : vadd(diffuse, spec);
}

HDB void ts_r_eval_pdf(V3 c0, F alpha, F eta0, F eta1, int dist,
                      V3 wo, V3 wi, int dists, V3* f, F* pdf_) {
  V3 wh = vnormalize(vadd(wo, wi));
  bool nanmask = !visfinite(wh);
  F d = mf_distribution(dist, wh, alpha, alpha, dists);
  F g = mf_visible_both(dist, wo, wi, alpha, alpha, dists);
  F fr = fresnel_dielectric(vdot(wi, wh), eta0, eta1);
  F denom = 4.0f * fabsf(wo.z) * fabsf(wi.z);
  F s = fin_(d * g * fr / mx(denom, 1e-20f));
  *f = nanmask ? vzero() : vscale(c0, s);
  F pdf = d * mf_visible(dist, wo, alpha, alpha, dists) *
              fabsf(vdot(wo, wh)) / mx(fabsf(cos_theta(wo)), 1e-20f) /
              (4.0f * vdot(wo, wh));
  pdf = fin(pdf) ? pdf : 0.0f;
  *pdf_ = wo.z * wi.z <= 0.0f ? 0.0f : pdf;
}

HDB void ts_t_eval_pdf(V3 c0, F alpha, F eta0, F eta1, int dist,
                      V3 wo, V3 wi, int dists, V3* f, F* pdf_) {
  bool same_side = wo.z * wi.z > 0.0f;
  F eta = wo.z > 0.0f ? csafe_ratio(eta1, eta0) : csafe_ratio(eta0, eta1);
  V3 wh = vnormalize(vadd(wo, vscale(wi, eta)));
  bool wh_bad = !visfinite(wh);
  V3 whp = wh.z < 0.0f ? vneg(wh) : wh;
  F cosoh = vdot(wo, whp);
  F fr = fresnel_dielectric(cosoh, eta0, eta1);
  F cosih = vdot(wi, whp);
  F sqrt_denom = cosoh + eta * cosih;
  F d = mf_distribution(dist, whp, alpha, alpha, dists);
  F g = mf_visible_both(dist, wo, wi, alpha, alpha, dists);
  F denom = fabsf(cos_theta(wo)) * fabsf(cos_theta(wi)) * sqrt_denom *
                sqrt_denom;
  F s = fin_(d * g * (1.0f - fr) * fabsf(cosih) * fabsf(cosoh) /
                 mx(denom, 1e-20f));
  V3 val = vscale(c0, s);
  val = wh_bad ? v3(1.0f, 1.0f, 1.0f) : val;
  *f = same_side ? vzero() : val;
  F cosoh_u = vdot(wo, wh);
  F cosih_u = vdot(wi, wh);
  F sqd_u = cosoh_u + eta * cosih_u;
  F dhdi = eta * eta * fabsf(cosih_u) / mx(sqd_u * sqd_u, 1e-20f);
  F d_u = mf_distribution(dist, wh, alpha, alpha, dists);
  F pdf = d_u * mf_visible(dist, wo, alpha, alpha, dists) *
              fabsf(cosoh_u) / mx(fabsf(cos_theta(wo)), 1e-20f) * dhdi;
  pdf = wh_bad ? 1.0f : pdf;
  *pdf_ = wo.z * wi.z > 0.0f ? 0.0f : pdf;
}

HDB void ashikhmin_eval_pdf(V3 c0, V3 c1, F alpha, int dist, V3 wo, V3 wi,
                           int dists, V3* f, F* pdf_) {
  *f = ashikhmin_eval(c0, c1, alpha, dist, wo, wi, dists);
  V3 wh_p = vnormalize(vadd(wo, wi));
  F p = mf_distribution(dist, wh_p, alpha, alpha, dists) *
            mf_visible(dist, wo, alpha, alpha, dists) *
            fabsf(vdot(wo, wh_p)) / mx(fabsf(cos_theta(wo)), 1e-20f) /
            (4.0f * vdot(wo, wh_p));
  p = fin(p) ? p : 0.0f;
  F pdf = 0.5f * (p + fabsf(cos_theta(wi)) * INV_PI);
  *pdf_ = wo.z * wi.z < 0.0f ? 0.0f : pdf;
}

HDB F ts_t_pdf(F alpha, F eta0, F eta1, int dist, V3 wo, V3 wi,
                  int dists) {
  F eta = wo.z > 0.0f ? csafe_ratio(eta1, eta0) : csafe_ratio(eta0, eta1);
  V3 wh = vnormalize(vadd(wo, vscale(wi, eta)));
  bool bad = !visfinite(wh);
  F sqrt_denom = vdot(wo, wh) + eta * vdot(wi, wh);
  F dhdi = eta * eta * fabsf(vdot(wi, wh)) /
               mx(sqrt_denom * sqrt_denom, 1e-20f);
  F pdf = mf_pdf_wh(dist, wo, wh, alpha, alpha, dists) * dhdi;
  pdf = bad ? 1.0f : pdf;
  return wo.z * wi.z > 0.0f ? 0.0f : pdf;
}

HDB F ashikhmin_pdf(F alpha, int dist, V3 wo, V3 wi, int dists) {
  V3 wh = vnormalize(vadd(wo, wi));
  F p = mf_pdf_wh(dist, wo, wh, alpha, alpha, dists) /
            (4.0f * vdot(wo, wh));
  p = fin(p) ? p : 0.0f;
  F pdf = 0.5f * (p + fabsf(cos_theta(wi)) * INV_PI);
  return wo.z * wi.z < 0.0f ? 0.0f : pdf;
}

HDB void slot_eval_pdf_fused(int stype, V3 c0, V3 c1, F p0, F p1,
                            F p2, int dist, V3 wo, V3 wi, int present,
                            const ShadeCfg& cfg, V3* f, F* pdf) {
  *f = vzero();
  *pdf = 0.0f;
  if (stype < 0 || stype > 9 || !((present >> stype) & 1)) return;
  switch (stype) {
    case T_LAMBERT_R:
      *f = vscale(c0, INV_PI);
      *pdf = cos_pdf_same(wo, wi);
      break;
    case T_OREN_NAYAR:
      *f = oren_nayar_eval(c0, p0, p1, wo, wi);
      *pdf = cos_pdf_same(wo, wi);
      break;
    case T_LAMBERT_T:
      *f = vscale(c0, INV_PI);
      *pdf = cos_pdf_opposite(wo, wi);
      break;
    case T_TS_R:
      ts_r_eval_pdf(c0, p0, p1, p2, dist, wo, wi, cfg.fam_dist[T_TS_R], f, pdf);
      break;
    case T_TS_T:
      ts_t_eval_pdf(c0, p0, p1, p2, dist, wo, wi, cfg.fam_dist[T_TS_T], f, pdf);
      break;
    case T_ASHIKHMIN:
      ashikhmin_eval_pdf(c0, c1, p0, dist, wo, wi, cfg.fam_dist[T_ASHIKHMIN],
                         f, pdf);
      break;
    default:
      break;
  }
}

// the reflection of wo about wh, detached (the sampled direction)
HD V3 reflect_detached(V3 wo, V3 wh) {
  cmath::V3 o = vval(wo), h = vval(wh);
  return vconst(cmath::vnormalize(
      cmath::vsub(cmath::vscale(h, 2.0f * cmath::vdot(o, h)), o)));
}

HDB void slot_sample(int stype, V3 c0, V3 c1, F p0, F p1, F p2,
                    int dist, V3 wo, float ux, float uy, int present,
                    const ShadeCfg& cfg, V3* f_, V3* wi_, F* pdf_,
                    int* kind_) {
  *f_ = vzero();
  *wi_ = v3(0.0f, 1.0f, 0.0f);
  *pdf_ = 0.0f;
  *kind_ = 0;
  if (stype < 0 || stype > 9 || !((present >> stype) & 1)) return;
  if (stype == T_LAMBERT_R || stype == T_OREN_NAYAR || stype == T_LAMBERT_T) {
    V3 wi_cos = vconst(cmath::sample_cosw_hemisphere(ux, uy));
    V3 wi_flip = v3(wi_cos.x, wi_cos.y, -wi_cos.z);
    V3 wi_same = wo.z < 0.0f ? wi_flip : wi_cos;
    V3 wi_opp = wo.z > 0.0f ? wi_flip : wi_cos;
    if (stype == T_LAMBERT_R) {
      *f_ = vscale(c0, INV_PI);
      *wi_ = wi_same;
      *pdf_ = cos_pdf_same(wo, wi_same);
    } else if (stype == T_OREN_NAYAR) {
      *f_ = oren_nayar_eval(c0, p0, p1, wo, wi_same);
      *wi_ = wi_same;
      *pdf_ = cos_pdf_same(wo, wi_same);
    } else {
      *f_ = vscale(c0, INV_PI);
      *wi_ = wi_opp;
      *pdf_ = cos_pdf_opposite(wo, wi_opp);
    }
    *kind_ = kind_of_type(stype);
    return;
  }
  V3 wi_mirror = v3(-wo.x, -wo.y, wo.z);
  F cth = cos_theta(wo);
  if (stype == T_FRESNEL_SPEC) {
    F fr = fresnel_dielectric(cth, p0, p1);
    bool refl = ux < fr;
    V3 f_refl = vscale(c0, fin_(fr / mx(fabsf(cth), 1e-20f)));
    bool entering = cth > 0.0f;
    F etai = entering ? p0 : p1;
    F etao = entering ? p1 : p0;
    float zsign = entering ? 1.0f : -1.0f;
    F eta_rel = csafe_ratio(etai, etao);
    bool ok_t;
    V3 wt = vconst(cmath::refract(vval(wo), cmath::v3(0.0f, 0.0f, zsign),
                                  val(eta_rel), &ok_t));
    F pdf_trans = 1.0f - fr;
    F ft_s = fin_(eta_rel * eta_rel * pdf_trans / mx(fabsf(wt.z), 1e-20f));
    V3 f_trans = ok_t ? vscale(c1, ft_s) : vzero();
    *f_ = refl ? f_refl : f_trans;
    *wi_ = refl ? wi_mirror : wt;
    *pdf_ = refl ? fr : pdf_trans;
    *kind_ = refl ? (REFLECTION | SPECULAR) : (TRANSMISSION | SPECULAR);
    return;
  }
  if (stype == T_TS_R || stype == T_TS_T) {
    int fd_rt = cfg.fam_dist[T_TS_R] | cfg.fam_dist[T_TS_T];
    V3 wh_r = vconst(cmath::mf_sample_wh(dist, vval(wo), ux, uy, val(p0),
                                         val(p0), fd_rt));
    if (stype == T_TS_R) {
      V3 wi = reflect_detached(wo, wh_r);
      F pdf = mf_pdf_wh(dist, wo, wh_r, p0, p0, cfg.fam_dist[T_TS_R]) /
                  (4.0f * vdot(wo, wh_r));
      pdf = fin(pdf) ? pdf : 0.0f;
      V3 f = wo.z * wi.z <= 0.0f
                 ? vzero()
                 : ts_r_eval(c0, p0, p1, p2, dist, wo, wi, cfg.fam_dist[T_TS_R]);
      *f_ = f;
      *wi_ = wi;
      *pdf_ = pdf;
    } else {
      F eta_t = wo.z > 0.0f ? csafe_ratio(p1, p2) : csafe_ratio(p2, p1);
      bool ok;
      V3 wi = vconst(cmath::refract(vval(wo), vval(wh_r), val(eta_t), &ok));
      *pdf_ = ok ? ts_t_pdf(p0, p1, p2, dist, wo, wi, cfg.fam_dist[T_TS_T])
                 : 0.0f;
      *f_ = ok ? ts_t_eval(c0, p0, p1, p2, dist, wo, wi, cfg.fam_dist[T_TS_T])
               : vzero();
      *wi_ = wi;
    }
    *kind_ = kind_of_type(stype);
    return;
  }
  if (stype == T_ASHIKHMIN) {
    int fd = cfg.fam_dist[T_ASHIKHMIN];
    bool spec_path = ux < 0.5f;
    float ux_spec = cmath::clampf_(ux * 2.0f, 0.0f, 0.999999f);
    float ux_diff = cmath::clampf_((1.0f - ux) * 2.0f, 0.0f, 0.999999f);
    V3 wi;
    if (spec_path) {
      V3 wh_a = vconst(cmath::mf_sample_wh(dist, vval(wo), ux_spec, uy,
                                           val(p0), val(p0), fd));
      wi = reflect_detached(wo, wh_a);
    } else {
      cmath::V3 raw = cmath::sample_cosw_hemisphere(ux_diff, uy);
      wi = vconst(raw.z < 0.0f ? cmath::v3(raw.x, raw.y, -raw.z) : raw);
    }
    bool bad_spec = spec_path && (wo.z * wi.z <= 0.0f);
    *pdf_ = ashikhmin_pdf(p0, dist, wo, wi, fd);
    *f_ = bad_spec ? vzero() : ashikhmin_eval(c0, c1, p0, dist, wo, wi, fd);
    *wi_ = wi;
    *kind_ = kind_of_type(stype);
    return;
  }
  if (stype == T_SPECULAR_R || stype == T_SPECULAR_T) {
    F cos_r = cos_theta(wi_mirror);
    F fr_sr = fresnel_dielectric(cos_r, p0, p1);
    F inv_c = fin_(1.0f / mx(fabsf(cos_r), 1e-20f));
    *f_ = stype == T_SPECULAR_R ? vscale(c0, fr_sr * inv_c)
                                : vscale(c0, (1.0f - fr_sr) * inv_c);
    *wi_ = wi_mirror;
    *pdf_ = 1.0f;
    *kind_ = kind_of_type(stype);
  }
}

// The slot sweeps over the kinds in `types` (the bounce passes ALL; the
// slot-sweep kernels K8 / K9 pass their caller's set).
template <class B>
HDB void bsdf_eval_pdf(const B& b, V3 wow, V3 wiw, const ShadeCfg& cfg,
                      V3* f_, F* pdf_, int types = ALL) {
  V3 wo = vnormalize(to_local(b.ts, b.bs, b.ns, wow));
  V3 wi = vnormalize(to_local(b.ts, b.bs, b.ns, wiw));
  bool is_refl = vdot(wow, b.ng) * vdot(wiw, b.ng) > 0.0f;
  V3 f = vzero();
  F total = 0.0f;
  int count = 0;
  SLOT_LOOP
  for (int k = 0; k < MAX_SLOTS; ++k) {
    const int pres = pick3(cfg.pres, k);
    if (pres == 0) continue;
    const Slot sl = slot_at(b, k);
    int kindk = sl.kind;
    bool m = (kindk & types) != 0;
    bool s = m && ((is_refl && (kindk & REFLECTION)) ||
                   (!is_refl && (kindk & TRANSMISSION)));
    V3 fk;
    F pk;
    slot_eval_pdf_fused(sl.type, sl.c0, sl.c1, sl.p0, sl.p1, sl.p2, sl.dist,
                        wo, wi, pres, cfg, &fk, &pk);
    f = vadd(f, s ? fk : vzero());
    total = total + (m ? mx(pk, 0.0f) : 0.0f);
    count += m;
  }
  F pdf = count > 0 ? total / (float)(count > 1 ? count : 1) : total;
  *pdf_ = wo.z == 0.0f ? 0.0f : pdf;
  *f_ = f;
}

template <class B>
HDB void bsdf_sample(const B& b, V3 wow, float ux, float uy,
                    const ShadeCfg& cfg, V3* f_, V3* wiw_, F* pdf_,
                    int* kind_, int types = ALL) {
  int nmatch = match_count(b, types);
  V3 wo = vnormalize(to_local(b.ts, b.bs, b.ns, wow));
  int idx = (int)(ux * (float)nmatch);
  int cap = nmatch - 1 > 0 ? nmatch - 1 : 0;
  idx = idx < cap ? idx : cap;
  int running = 0, sk = 0;
#pragma unroll
  for (int k = 0; k < MAX_SLOTS; ++k) {
    bool m = (b.kind[k] & types) != 0;
    if (m && running == idx) sk = k;
    running += m;
  }
  const Slot ss = slot_at(b, sk);
  V3 f, wi;
  F pdf;
  int skind;
  slot_sample(ss.type, ss.c0, ss.c1, ss.p0, ss.p1, ss.p2, ss.dist, wo, ux, uy,
              cfg.any_pres, cfg, &f, &wi, &pdf, &skind);
  skind = skind & types;
  bool is_spec = (ss.kind & SPECULAR) != 0;
  V3 wiw = to_world(b.ts, b.bs, b.ns, wi);
  *wiw_ = wiw;
  bool dead = (nmatch == 0) || (pdf == 0.0f);
  if (cfg.single_col) {
    *f_ = dead ? vzero() : f;
    *pdf_ = dead ? 0.0f : pdf;
    *kind_ = dead ? 0 : skind;
    return;
  }
  bool multi = (nmatch > 1) && !is_spec;
  V3 f_out = f;
  F pdf_out = pdf;
  if (multi) {
    bool is_refl = vdot(wow, b.ng) * vdot(wiw, b.ng) > 0.0f;
    V3 f_acc = vzero();
    F pdf_acc = 0.0f;
    SLOT_LOOP
    for (int k = 0; k < MAX_SLOTS; ++k) {
      const int pres = pick3(cfg.pres, k);
      if (pres == 0) continue;
      const Slot sl = slot_at(b, k);
      int kindk = sl.kind;
      bool s = ((kindk & skind) != 0) &&
               ((is_refl && (kindk & REFLECTION)) ||
                (!is_refl && (kindk & TRANSMISSION)));
      V3 fk;
      F pk;
      slot_eval_pdf_fused(sl.type, sl.c0, sl.c1, sl.p0, sl.p1, sl.p2,
                          sl.dist, wo, wi, pres, cfg, &fk, &pk);
      f_acc = vadd(f_acc, s ? fk : vzero());
      pdf_acc = pdf_acc + (s ? mx(pk, 0.0f) : 0.0f);
    }
    f_out = f_acc;
    pdf_out = pdf_acc / mx((float)nmatch, 1.0f);
  }
  *f_ = dead ? vzero() : f_out;
  *pdf_ = dead ? 0.0f : pdf_out;
  *kind_ = dead ? 0 : skind;
}

// ---------------------------------------------------------------------------
// the bounce body
// ---------------------------------------------------------------------------

// The light a lane hit (-1: none): the sphere row's column 21 on a
// sphere hit, else the triangle's light id (input column 38), truncated
// by (int), the sphere row clamped into the table as hit_info reads it.
// With emission_gate it is the one statement of when a lane adds
// emission: the body asks it, and so does the backward's classifier
// (cbounce_ad.cuh needs_body), on the float instantiation.
HD int hit_light_id(bool hitmask, bool is_sph, int s_idx, float tri_light,
                    const Tables& tb) {
  int id = (int)(is_sph ? tb.stab[tb.sp * row_idx(s_idx, tb.ns) + 21]
                        : tri_light);
  return hitmask ? id : -1;
}
HD bool emission_gate(bool alive, bool hitmask, int light_id) {
  return alive && hitmask && light_id >= 0;
}

// The output sink of the shade over an array: out(j, v) sets res[j].
// (The forward kernels' sink writes the lane's output column instead,
// cbounce.cuh ColumnOut.)
struct ArrayOut {
  F* res;
  HD void operator()(int j, F v) const { res[j] = v; }
};

// The first half of the bounce: the hit's shading info from the lane's
// input columns 0:39 (the layout the fused and the split hit input
// share).  xv[c]: the lane's input column c (an array, or a reader that
// loads each column where it is used).  Sets rows[SLOT_S]; b0 / b1 are
// the triangle barycentrics.
struct HitInfo {
  V3 pos, pos_err, ng, ns, dpdu, dpdv;
  F b0, b1;
  int mat_id, light_id;
  bool hitmask, is_sph;
};

template <class X>
HDB void hit_info(const X& xv, const Tables& tb, HitInfo* h,
                  int rows[N_ROW_SLOTS]) {
  V3 o_ray = v3(xv[0], xv[1], xv[2]);
  V3 d = v3(xv[3], xv[4], xv[5]);
  h->hitmask = xv[7] > 0.5f;
  h->is_sph = xv[8] > 0.5f;
  int s_idx = (int)xv[9];
  rows[SLOT_S] = row_idx(s_idx, tb.ns);
  Row srow = mkrow(tb.stab + tb.sp * rows[SLOT_S], SLOT_S);
  // the triangle row: input columns 13:39
  auto tr = [&](int j) { return xv[13 + j]; };

  V3 tv0 = v3(tr(0), tr(1), tr(2)), tv1 = v3(tr(3), tr(4), tr(5)),
     tv2 = v3(tr(6), tr(7), tr(8));
  bary_from_vertices(o_ray, d, tv0, tv1, tv2, &h->b0, &h->b1);
  F b0 = h->b0, b1 = h->b1;
  F b2 = 1.0f - b0 - b1;
  if (h->is_sph) {
    sphere_shading_from_row(srow, v3(xv[10], xv[11], xv[12]), &h->pos,
                            &h->ng, &h->dpdu, &h->dpdv, &h->pos_err);
    h->ns = h->ng;
  } else {
    h->pos = vadd(vadd(vscale(tv0, b0), vscale(tv1, b1)), vscale(tv2, b2));
    h->pos_err =
        vscale(vadd(vadd(vabs(vscale(tv0, b0)), vabs(vscale(tv1, b1))),
                    vabs(vscale(tv2, b2))),
               GAMMA7);
    tri_dpduv(tv0, tv1, tv2, tr(18), tr(19), tr(20), tr(21), tr(22), tr(23),
              &h->dpdu, &h->dpdv);
    V3 n0 = v3(tr(9), tr(10), tr(11)), n1 = v3(tr(12), tr(13), tr(14)),
       n2 = v3(tr(15), tr(16), tr(17));
    V3 ns_raw = vnormalize(vadd(vadd(vscale(n0, b0), vscale(n1, b1)),
                                vscale(n2, b2)));
    h->ng = vnormalize(vcross(h->dpdu, h->dpdv));
    h->ns = vdot(ns_raw, h->ng) < 0.0f ? vneg(ns_raw) : ns_raw;
  }
  h->mat_id = (int)(h->is_sph ? rawf(srow, 20) : val(tr(24)));
  h->light_id = hit_light_id(h->hitmask, h->is_sph, s_idx, val(tr(25)), tb);
}

// What the shade proper reads besides the light table: the hit info and
// the texture-resolved material parameters, the path state and the
// lane's sample numbers.
struct ShadeIn {
  V3 d, pos, pos_err, ng, ns, dpdu;
  int mtype;
  V3 kd, ks;
  F sigma, rough, eta, dissolve;
  int light_id;
  bool hitmask;
  V3 beta, L;
  bool specular;
  int sel_prev;
  F wb_prev;
  bool nee_prev, alive;
  int lidx;
  F selpdf;
  float ul0, ul1, ub0, ub1, u_rr, bounce;
};

// The second half of the bounce: emission, the material recipe, NEE,
// the BSDF sample, beta and Russian roulette.  out(j, v) receives the
// first 28 output columns in order (the rest are zero); sets
// rows[SLOT_LE] / [SLOT_LS].
template <class Out>
HDB void shade_core(const ShadeIn& s, const Tables& tb, const ShadeCfg& cfg,
                    const Out& out, int rows[N_ROW_SLOTS]) {
  const V3 d = s.d, pos = s.pos, pos_err = s.pos_err, ng = s.ng;
  V3 beta = s.beta, L = s.L;
  bool specular = s.specular;
  int sel_prev = s.sel_prev;
  F wb_prev = s.wb_prev;
  bool nee_prev = s.nee_prev, alive = s.alive;
  int lidx = s.lidx, light_id = s.light_id;
  F selpdf = s.selpdf;
  float bounce = s.bounce;

  bool lane_active = alive && s.hitmask;

  // (2) emitted radiance
  rows[SLOT_LE] = row_idx(light_id > 0 ? light_id : 0, tb.nl);
  Row lerow = mkrow(tb.ltab + (long)tb.lp * rows[SLOT_LE], SLOT_LE);
  V3 le = ld3(lerow, cfg.emi);
  bool emit_gate = emission_gate(alive, s.hitmask, light_id);
  F w_emit = (((bounce == 0.0f) || specular) ? 1.0f : 0.0f) +
             ((nee_prev && (light_id == sel_prev)) ? wb_prev : F(0.0f));
  L = vadd(L, emit_gate ? vscale(vmul(beta, le), w_emit) : vzero());

  // (3) scattering + NEE
  V3 wo = vneg(d);
  Slots bsdf = build_slots(s.mtype, s.kd, s.ks, s.sigma, s.rough, s.eta,
                           s.dissolve, s.ns, ng, s.dpdu);
  bool do_nee = lane_active && (match_count(bsdf, ALL_NON_SPECULAR) > 0);
  rows[SLOT_LS] = row_idx(lidx > 0 ? lidx : 0, tb.nl);
  Row lrow = mkrow(tb.ltab + (long)tb.lp * rows[SLOT_LS], SLOT_LS);
  LightSample ls = light_sample_rows(lrow, cfg, pos, s.ul0, s.ul1);
  V3 f_raw;
  F spdf;
  bsdf_eval_pdf(bsdf, wo, ls.wi, cfg, &f_raw, &spdf);
  V3 contrib;
  bool need_shadow;
  direct_light_contrib(ls, f_raw, spdf, bsdf.ns, &contrib, &need_shadow);
  F inv_sel = 1.0f / mx(selpdf, 1e-20f);
  V3 contrib_out = do_nee ? vscale(vmul(beta, contrib), inv_sel) : vzero();
  bool need_sh_out = need_shadow && do_nee;
  V3 d_sh = vsub(ls.pfrom, pos);
  V3 o_sh = offset_ray_origin(pos, pos_err, ng, d_sh);
  V3 seg = vsub(ls.pfrom, o_sh);
  F dist_sh = sqrtf(mx(vlength2(seg), 1e-20f));
  V3 dirn = vscale(seg, 1.0f / dist_sh);
  F sh_t = dist_sh * (float)(1.0 - 1e-3);

  // (4) bsdf sample for path continuation
  V3 f, wi;
  F pdf;
  int kind;
  bsdf_sample(bsdf, wo, s.ub0, s.ub1, cfg, &f, &wi, &pdf, &kind);
  bool cont = lane_active && !is_black(f) && (pdf > 0.0f);
  bool spec_new = (kind & SPECULAR) != 0;
  specular = (lane_active && spec_new) || (!lane_active && specular);
  F wb = path_mis_weight_rows(lrow, cfg, selpdf, pos, wi, pdf, kind, f);
  sel_prev = lane_active ? lidx : sel_prev;
  wb_prev = lane_active ? wb : wb_prev;
  nee_prev = do_nee;
  F ratio = fabsf(vdot(wi, bsdf.ns)) / mx(pdf, 1e-20f);
  bool overflow = ratio > 1e12f;
  cont = cont && !overflow;
  ratio = cont ? mn(ratio, 1e12f) : F(0.0f);
  V3 new_beta = vscale(vmul(beta, f), ratio);
  bool beta_ok = valid(new_beta);
  beta = (cont && beta_ok) ? new_beta : beta;
  alive = lane_active && cont && beta_ok;

  V3 o = offset_ray_origin(pos, pos_err, ng, wi);
  bool degenerate = vlength2(wi) < 1e-12f;
  V3 d_out = degenerate ? v3(0.0f, 0.0f, 1.0f) : wi;
  alive = alive && !degenerate;

  // (5) russian roulette
  F lum = luminance(beta);
  float q = cfg.rr_q;
  bool rr_active = (bounce + 1.0f) >= (float)cfg.min_depth;
  bool roulette = rr_active && (lum < cfg.rr_threshold);
  bool killed = roulette && (s.u_rr < q);
  beta = (roulette && !killed) ? vscale(beta, cfg.rr_scale) : beta;
  alive = alive && !killed;

  out(0, o.x);
  out(1, o.y);
  out(2, o.z);
  out(3, d_out.x);
  out(4, d_out.y);
  out(5, d_out.z);
  out(6, L.x);
  out(7, L.y);
  out(8, L.z);
  out(9, beta.x);
  out(10, beta.y);
  out(11, beta.z);
  out(12, alive ? 1.0f : 0.0f);
  out(13, specular ? 1.0f : 0.0f);
  out(14, (float)sel_prev);
  out(15, wb_prev);
  out(16, nee_prev ? 1.0f : 0.0f);
  out(17, o_sh.x);
  out(18, o_sh.y);
  out(19, o_sh.z);
  out(20, dirn.x);
  out(21, dirn.y);
  out(22, dirn.z);
  out(23, sh_t);
  out(24, need_sh_out ? 1.0f : 0.0f);
  out(25, contrib_out.x);
  out(26, contrib_out.y);
  out(27, contrib_out.z);
}

// The fused bounce (K3, and K4 on the taped scalar): xv[c] = the lane's
// input column c (as hit_info's); out(j, v) receives its first 28
// output columns (the rest are zero); rows = the table row each row
// slot read.
template <class X, class Out>
HDB void cbody_core(const X& xv, const Tables& tb, const ShadeCfg& cfg,
                    const Out& out, int rows[N_ROW_SLOTS]) {
  HitInfo h;
  hit_info(xv, tb, &h, rows);
  rows[SLOT_M] = row_idx(h.mat_id > 0 ? h.mat_id : 0, tb.nm);
  Row mrow = mkrow(tb.mtab + tb.mp * rows[SLOT_M], SLOT_M);
  ShadeIn s;
  s.d = v3(xv[3], xv[4], xv[5]);
  s.pos = h.pos;
  s.pos_err = h.pos_err;
  s.ng = h.ng;
  s.ns = h.ns;
  s.dpdu = h.dpdu;
  s.mtype = (int)rawf(mrow, 0);
  s.kd = v3(mrow[1], mrow[2], mrow[3]);
  s.ks = v3(mrow[4], mrow[5], mrow[6]);
  s.sigma = mrow[7];
  s.rough = mrow[8];
  s.eta = mrow[9];
  s.dissolve = mrow[10];
  s.light_id = h.light_id;
  s.hitmask = h.hitmask;
  s.beta = v3(xv[39], xv[40], xv[41]);
  s.L = v3(xv[42], xv[43], xv[44]);
  s.specular = xv[45] > 0.5f;
  s.sel_prev = (int)xv[46];
  s.wb_prev = xv[47];
  s.nee_prev = xv[48] > 0.5f;
  s.alive = xv[49] > 0.5f;
  s.lidx = (int)xv[50];
  s.selpdf = xv[51];
  s.ul0 = val(xv[52]);
  s.ul1 = val(xv[53]);
  s.ub0 = val(xv[54]);
  s.ub1 = val(xv[55]);
  s.u_rr = val(xv[56]);
  s.bounce = val(xv[57]);
  shade_core(s, tb, cfg, out, rows);
}
