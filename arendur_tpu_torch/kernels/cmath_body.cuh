// The differentiable part of the shading math (see cmath.cuh), written
// over a scalar type F and a table-row type Row.  Not a header of its
// own: it is included inside namespace cmath (F = float) and namespace
// cmath_ad (F = ad::R), which define F, Row and the clamp/min/max
// primitives first.  HDB marks the larger functions: inlined in the
// forward, real calls in the backward, whose every operation also
// writes its tape node.

struct V3 {
  F x, y, z;
};
HD V3 v3(F a, F b, F c) {
  V3 r;
  r.x = a;
  r.y = b;
  r.z = c;
  return r;
}
HD V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
HD V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
HD V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
HD V3 vscale(V3 a, F s) { return v3(a.x * s, a.y * s, a.z * s); }
HD V3 vmul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
HD F vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
HD F vlength2(V3 a) { return vdot(a, a); }
HDB V3 vnormalize(V3 a) {
  F n2 = mx(vlength2(a), 1e-30f);
  F s = sqrtf(1.0f / n2);
  return vscale(a, s);
}
HD V3 vabs(V3 a) { return v3(fabsf(a.x), fabsf(a.y), fabsf(a.z)); }
HD bool visfinite(V3 a) { return fin(a.x) && fin(a.y) && fin(a.z); }
HD V3 vzero() { return v3(0.0f, 0.0f, 0.0f); }

HD F luminance(V3 c) {
  return 0.212671f * c.x + 0.715160f * c.y + 0.072169f * c.z;
}
HD bool is_black(V3 c) {
  return (c.x == 0.0f) && (c.y == 0.0f) && (c.z == 0.0f);
}
HD bool valid(V3 c) {
  return fin(c.x) && c.x >= 0.0f && fin(c.y) && c.y >= 0.0f &&
         fin(c.z) && c.z >= 0.0f;
}
HD V3 sanitize(V3 c) { return valid(c) ? c : vzero(); }

// local-frame trig
HD F cos_theta(V3 w) { return w.z; }
HD F cos2_theta(V3 w) { return w.z * w.z; }
HD F sin2_theta(V3 w) { return fabsf(1.0f - cos2_theta(w)); }
HD F sin_theta(V3 w) { return sqrtf(mx(sin2_theta(w), 1e-30f)); }
HD F safe_div(F a, F b) {
  const F eps = 1e-20f;
  F safe = fabsf(b) < eps ? (b < 0.0f ? -eps : eps) : b;
  return a / safe;
}
HD F tan_theta(V3 w) { return safe_div(sin_theta(w), cos_theta(w)); }
HD F tan2_theta(V3 w) {
  return sin2_theta(w) / mx(cos2_theta(w), 1e-30f);
}
HD F cos_phi(V3 w) {
  F st = sin_theta(w);
  return st == 0.0f ? 1.0f : clampf_(w.x / st, -1.0f, 1.0f);
}
HD F sin_phi(V3 w) {
  F st = sin_theta(w);
  return st == 0.0f ? 0.0f : clampf_(w.y / st, -1.0f, 1.0f);
}
HD F cos2_phi(V3 w) {
  F c = cos_phi(w);
  return c * c;
}
HD F sin2_phi(V3 w) {
  F s = sin_phi(w);
  return s * s;
}


HD F acos_poly(F x) {
  F xa = clampf_(fabsf(x), 0.0f, 1.0f);
  F p = -0.0187293f;
  p = 0.0742610f + p * xa;
  p = -0.2121144f + p * xa;
  p = 1.5707288f + p * xa;
  F v = p * sqrtf(1.0f - xa);
  return x >= 0.0f ? v : PI - v;
}


HDB void get_basis_from(V3 d, V3* u, V3* v) {
  bool near_z = fabsf(fabsf(d.z) - 1.0f) < 1e-5f;
  V3 up = v3(0.0f, near_z ? 1.0f : 0.0f, near_z ? 0.0f : 1.0f);
  *u = vnormalize(vcross(up, d));
  *v = vnormalize(vcross(d, *u));
}

HD V3 to_local(V3 t, V3 b, V3 n, V3 v) {
  return v3(vdot(v, t), vdot(v, b), vdot(v, n));
}
HD V3 to_world(V3 t, V3 b, V3 n, V3 v) {
  return v3(v.x * t.x + v.y * b.x + v.z * n.x,
            v.x * t.y + v.y * b.y + v.z * n.y,
            v.x * t.z + v.y * b.z + v.z * n.z);
}

// row-vector transforms by a 16-float row (cgmath row layout)
HDB V3 tp16(Row m, V3 p) {
  F ox = p.x * m[0] + p.y * m[4] + p.z * m[8] + m[12];
  F oy = p.x * m[1] + p.y * m[5] + p.z * m[9] + m[13];
  F oz = p.x * m[2] + p.y * m[6] + p.z * m[10] + m[14];
  F w = p.x * m[3] + p.y * m[7] + p.z * m[11] + m[15];
  F inv = 1.0f / (fabsf(w) < 1e-20f ? 1.0f : w);
  return v3(ox * inv, oy * inv, oz * inv);
}
HD V3 tv16(Row m, V3 v) {
  return v3(v.x * m[0] + v.y * m[4] + v.z * m[8],
            v.x * m[1] + v.y * m[5] + v.z * m[9],
            v.x * m[2] + v.y * m[6] + v.z * m[10]);
}


HD F power_heuristic(F pdff, F pdfg) {
  F f = 1.0f * pdff;
  F g = 1.0f * pdfg;
  return (f * f) / mx(f * f + g * g, 1e-30f);
}

// fresnel
HDB F fresnel_dielectric(F cos_theta_i, F etai, F etat) {
  bool entering = cos_theta_i >= 0.0f;
  F ei = entering ? etai : etat;
  F et = entering ? etat : etai;
  F ci = fabsf(cos_theta_i);
  F sin2_i = mx(1.0f - ci * ci, 0.0f);
  F eta = ei / (fabsf(et) < 1e-20f ? 1e-20f : et);
  eta = clampf_(eta, -1e3f, 1e3f);
  F sin2_t = eta * eta * sin2_i;
  bool total = sin2_t >= 1.0f;
  F ct = sqrtf(mx(1.0f - sin2_t, 1e-12f));
  F etci = et * ci;
  F eict = ei * ct;
  F r_para = (etci - eict) /
                 (fabsf(etci + eict) < 1e-20f ? 1e-20f : etci + eict);
  F eici = ei * ci;
  F etct = et * ct;
  F r_perp = (eici - etct) /
                 (fabsf(eici + etct) < 1e-20f ? 1e-20f : eici + etct);
  F fr = 0.5f * (r_para * r_para + r_perp * r_perp);
  return total ? 1.0f : fr;
}
HD F csafe_ratio(F a, F b) {
  F r = a / (fabsf(b) < 1e-20f ? 1e-20f : b);
  return clampf_(r, -1e3f, 1e3f);
}
HD V3 schlick_fresnel(F cost, V3 s) {
  F c5 = powf(1.0f - cost, 5.0f);
  return v3(s.x + c5 * (1.0f - s.x), s.y + c5 * (1.0f - s.y),
            s.z + c5 * (1.0f - s.z));
}

// microfacet distributions
HD F roughness_to_alpha(F roughness) {
  F x = logf(mx(roughness, 1e-3f));
  return 1.62142f + 0.819955f * x + 0.1734f * x * x +
         0.0171201f * (x * x * x) + 0.000640711f * powf(x, 4.0f);
}
HDB F d_beckmann(V3 wh, F ax, F ay) {
  F cos2 = cos2_theta(wh);
  F tan2 = tan2_theta(wh);
  F cos2p = cos2_phi(wh);
  F sin2p = sin2_phi(wh);
  F expo = mx(-tan2 * (cos2p / (ax * ax) + sin2p / (ay * ay)), -60.0f);
  F val = expf(expo) / mx(PI * ax * ay * cos2 * cos2, 1e-30f);
  return fin(val) ? val : 0.0f;
}
HDB F d_trowbridge(V3 wh, F ax, F ay) {
  F cos2 = cos2_theta(wh);
  F tan2 = tan2_theta(wh);
  F cos2p = cos2_phi(wh);
  F sin2p = sin2_phi(wh);
  F last = mn(1.0f + tan2 * (cos2p / (ax * ax) + sin2p / (ay * ay)),
                  1e15f);
  F val = 1.0f / mx(PI * ax * ay * cos2 * cos2 * last * last, 1e-30f);
  return (fin(tan2) && fin(val)) ? val : 0.0f;
}
// dists: bit 0 = Beckmann present, bit 1 = Trowbridge present; a family
// restricted to exactly one model uses it, otherwise `dist` decides
HD bool use_beckmann(int dist, int dists) {
  if (dists == 1) return true;
  if (dists == 2) return false;
  return dist == D_BECKMANN;
}
HD F mf_distribution(int dist, V3 wh, F ax, F ay, int dists) {
  return use_beckmann(dist, dists) ? d_beckmann(wh, ax, ay)
                                   : d_trowbridge(wh, ax, ay);
}
// sqrt whose derivative stays finite at 0 (render/cmath.py _sqrt_nz)
HD F sqrt_nz(F x) { return x == 0.0f ? F(0.0f) : sqrtf(x); }
HDB F lambda_beckmann(V3 w, F ax, F ay) {
  F tant = fabsf(tan_theta(w));
  F alpha = sqrt_nz(cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay);
  F a = 1.0f / mx(alpha * tant, 1e-20f);
  F poly = (1.0f - 1.259f * a + 0.396f * a * a) /
               (3.535f * a + 2.181f * a * a);
  F val = a >= 1.6f ? 0.0f : poly;
  return fin(tant) ? val : 0.0f;
}
HDB F lambda_trowbridge(V3 w, F ax, F ay) {
  F tabs = fabsf(tan_theta(w));
  F alpha = sqrt_nz(cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay);
  F term = mn(alpha * tabs, 1e15f);
  F val = 0.5f * (-1.0f + sqrtf(1.0f + term * term));
  return fin(tabs) ? val : 0.0f;
}
HD F mf_lam(int dist, V3 w, F ax, F ay, int dists) {
  return use_beckmann(dist, dists) ? lambda_beckmann(w, ax, ay)
                                   : lambda_trowbridge(w, ax, ay);
}
HD F mf_visible(int dist, V3 w, F ax, F ay, int dists) {
  return 1.0f / (1.0f + mf_lam(dist, w, ax, ay, dists));
}
HD F mf_visible_both(int dist, V3 w0, V3 w1, F ax, F ay,
                         int dists) {
  return 1.0f / (1.0f + mf_lam(dist, w0, ax, ay, dists) +
                 mf_lam(dist, w1, ax, ay, dists));
}
HDB F mf_pdf_wh(int dist, V3 wo, V3 wh, F ax, F ay, int dists) {
  return mf_distribution(dist, wh, ax, ay, dists) *
         mf_visible(dist, wo, ax, ay, dists) * fabsf(vdot(wo, wh)) /
         mx(fabsf(cos_theta(wo)), 1e-20f);
}

