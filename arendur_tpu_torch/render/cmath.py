"""Component-form shading math over lane tensors (port of
arendur_tpu/render/cmath.py).

A 3-vector is a tuple of three [N] tensors, a 2-d sample a tuple of
two, masks are bool [N] tensors.  The functions follow the JAX
package's operation order so both agree to f32 roundoff; the hand-
written bounce-shade kernel (kernels/cbounce.cu) translates the same
functions to per-lane CUDA C++, and this module is its plain version.

Twins: geometry/vec.py + frame.py (v* / frame helpers), transform.py
row16 (tp16 / tv16), bxdf/fresnel.py, bxdf/microfacet.py (mf_*),
sampling/warps.py and bxdf/slots.py (CSlots + slot/bsdf functions).
The polynomial acos_poly / atan2_poly stand in for torch.acos /
torch.atan2 on purpose: both JAX paths use them, and the goldens were
calibrated with them.
"""

from __future__ import annotations

import math

import torch

from arendur_tpu_torch.bxdf.types import (
    REFLECTION, TRANSMISSION, SPECULAR, ALL,
    T_LAMBERT_R, T_LAMBERT_T, T_OREN_NAYAR, T_FRESNEL_SPEC,
    T_TS_R, T_TS_T, T_ASHIKHMIN, T_SPECULAR_R, T_SPECULAR_T,
    D_BECKMANN, D_TROWBRIDGE, KIND_OF_TYPE)

PI = math.pi
INV_PI = 1.0 / PI
_FMAX = 1e12
# The reference writes (1 + sx^2) where pbrt has sqrt(1 + sx^2) in its
# Trowbridge slope sampling (microfacet.rs:298), which makes its sampler
# disagree with its own pdf.  False keeps the consistent sqrt form, as
# the JAX package does (bxdf/microfacet.py:24); kernels/cmath.cuh holds
# the same constant.
TR_COMPAT_NO_SQRT = False

W = torch.where


def _max(x, c):
    return torch.clamp(x, min=c)


def _min(x, c):
    return torch.clamp(x, max=c)


# ---------------------------------------------------------------------------
# vec3-as-tuple algebra
# ---------------------------------------------------------------------------

def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vlength2(a):
    return vdot(a, a)


def vnormalize(a, eps: float = 1e-30):
    n2 = _max(vlength2(a), eps)
    s = torch.sqrt(1.0 / n2)
    return vscale(a, s)


def vwhere(m, a, b):
    return (W(m, a[0], b[0]), W(m, a[1], b[1]), W(m, a[2], b[2]))


def vabs(a):
    return (torch.abs(a[0]), torch.abs(a[1]), torch.abs(a[2]))


def visfinite(a):
    return torch.isfinite(a[0]) & torch.isfinite(a[1]) \
        & torch.isfinite(a[2])


def vzero_like(s):
    z = torch.zeros_like(s)
    return (z, z, z)


# spectrum helpers

def luminance(c):
    return 0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2]


def is_black(c):
    return (c[0] == 0.0) & (c[1] == 0.0) & (c[2] == 0.0)


def valid(c):
    ok0 = torch.isfinite(c[0]) & (c[0] >= 0.0)
    ok1 = torch.isfinite(c[1]) & (c[1] >= 0.0)
    ok2 = torch.isfinite(c[2]) & (c[2] >= 0.0)
    return ok0 & ok1 & ok2


def sanitize(c):
    return vwhere(valid(c), c, vzero_like(c[0]))


# ---------------------------------------------------------------------------
# local-frame trig (w is a local-frame tuple)
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[2]


def cos2_theta(w):
    return w[2] * w[2]


def sin2_theta(w):
    return torch.abs(1.0 - cos2_theta(w))


def sin_theta(w):
    return torch.sqrt(_max(sin2_theta(w), 1e-30))


def _safe_div(a, b, eps=1e-20):
    safe = W(torch.abs(b) < eps, W(b < 0, -eps, eps), b)
    return a / safe


def tan_theta(w):
    return _safe_div(sin_theta(w), cos_theta(w))


def tan2_theta(w):
    return sin2_theta(w) / _max(cos2_theta(w), 1e-30)


def cos_phi(w):
    st = sin_theta(w)
    return W(st == 0.0, 1.0, torch.clamp(w[0] / st, -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return W(st == 0.0, 0.0, torch.clamp(w[1] / st, -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def acos_poly(x):
    """A&S 4.4.45 (twin: frame.acos_poly; same coefficients)."""
    xa = torch.clamp(torch.abs(x), 0.0, 1.0)
    p = -0.0187293
    for c in (0.0742610, -0.2121144, 1.5707288):
        p = c + p * xa
    v = p * torch.sqrt(1.0 - xa)
    return W(x >= 0.0, v, PI - v)


def atan2_poly(y, x):
    """A&S 4.4.49 (twin: frame.atan2_poly)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / W(hi < 1e-30, 1e-30, hi)
    z2 = z * z
    p = 0.0208351
    for c in (-0.0851330, 0.1801410, -0.3302995, 0.9998660):
        p = c + p * z2
    a = p * z
    a = W(ay > ax, 0.5 * PI - a, a)
    a = W(x < 0.0, PI - a, a)
    return W(y < 0.0, -a, a)


def refract(wo, n, eta):
    """(wt, ok); twin: frame.refract."""
    ct = vdot(wo, n)
    sin2 = _max(1.0 - ct * ct, 0.0)
    sin2_t = eta * eta * sin2
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(_max(1.0 - sin2_t, 1e-12))
    wt = vadd(vscale(wo, -eta), vscale(n, eta * ct - cos_t))
    return vwhere(ok, wt, vzero_like(ct)), ok


def get_basis_from(d):
    """(u, v) completing d to an orthonormal basis."""
    near_z = torch.abs(torch.abs(d[2]) - 1.0) < 1e-5
    zero = torch.zeros_like(d[0])
    up = (zero, W(near_z, 1.0, 0.0), W(near_z, 0.0, 1.0))
    u = vnormalize(vcross(up, d))
    v = vnormalize(vcross(d, u))
    return u, v


def to_local(t, b, n, v):
    return (vdot(v, t), vdot(v, b), vdot(v, n))


def to_world(t, b, n, v):
    return (v[0] * t[0] + v[1] * b[0] + v[2] * n[0],
            v[0] * t[1] + v[1] * b[1] + v[2] * n[1],
            v[0] * t[2] + v[1] * b[2] + v[2] * n[2])


# row-vector transforms; m is a 16-tuple of lane tensors

def tp16(m, p):
    x, y, z = p
    ox = x * m[0] + y * m[4] + z * m[8] + m[12]
    oy = x * m[1] + y * m[5] + z * m[9] + m[13]
    oz = x * m[2] + y * m[6] + z * m[10] + m[14]
    w = x * m[3] + y * m[7] + z * m[11] + m[15]
    inv = 1.0 / W(torch.abs(w) < 1e-20, 1.0, w)
    return (ox * inv, oy * inv, oz * inv)


def tv16(m, v):
    x, y, z = v
    return (x * m[0] + y * m[4] + z * m[8],
            x * m[1] + y * m[5] + z * m[9],
            x * m[2] + y * m[6] + z * m[10])


# ---------------------------------------------------------------------------
# warps (twin: sampling/warps.py); u = (ux, uy)
# ---------------------------------------------------------------------------

def sample_concentric_disk(u):
    ux = 2.0 * u[0] - 1.0
    uy = 2.0 * u[1] - 1.0
    at_origin = (ux == 0.0) & (uy == 0.0)
    x_bigger = torch.abs(ux) > torch.abs(uy)
    safe_ux = W(ux == 0.0, 1.0, ux)
    safe_uy = W(uy == 0.0, 1.0, uy)
    r = W(x_bigger, ux, uy)
    theta = W(x_bigger, (PI / 4.0) * (uy / safe_ux),
              (PI / 2.0) - (PI / 4.0) * (ux / safe_uy))
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    zero = torch.zeros_like(px)
    return (W(at_origin, zero, px), W(at_origin, zero, py))


def sample_cosw_hemisphere(u):
    dx, dy = sample_concentric_disk(u)
    z = torch.sqrt(torch.abs(1.0 - dx * dx - dy * dy))
    return (dx, dy, z)


def sample_uniform_triangle(u):
    sqrtux = torch.sqrt(u[0])
    x = 1.0 - sqrtux
    y = sqrtux * u[1]
    return (x, y, 1.0 - x - y)


def power_heuristic(nf, pdff, ng, pdfg):
    f = nf * pdff
    g = ng * pdfg
    return (f * f) / _max(f * f + g * g, 1e-30)


# ---------------------------------------------------------------------------
# fresnel (twin: bxdf/fresnel.py)
# ---------------------------------------------------------------------------

def fresnel_dielectric(cos_theta_i, etai, etat):
    entering = cos_theta_i >= 0.0
    ei = W(entering, etai, etat)
    et = W(entering, etat, etai)
    ci = torch.abs(cos_theta_i)
    sin2_i = _max(1.0 - ci * ci, 0.0)
    eta = ei / W(torch.abs(et) < 1e-20, 1e-20, et)
    eta = torch.clamp(eta, -1e3, 1e3)
    sin2_t = eta * eta * sin2_i
    total = sin2_t >= 1.0
    ct = torch.sqrt(_max(1.0 - sin2_t, 1e-12))
    etci = et * ci
    eict = ei * ct
    r_para = (etci - eict) / W(torch.abs(etci + eict) < 1e-20, 1e-20,
                               etci + eict)
    eici = ei * ci
    etct = et * ct
    r_perp = (eici - etct) / W(torch.abs(eici + etct) < 1e-20, 1e-20,
                               eici + etct)
    fr = 0.5 * (r_para * r_para + r_perp * r_perp)
    return W(total, 1.0, fr)


def _csafe_ratio(a, b):
    r = a / W(torch.abs(b) < 1e-20, 1e-20, b)
    return torch.clamp(r, -1e3, 1e3)


def schlick_fresnel(cost, s):
    c5 = (1.0 - cost) ** 5
    return (s[0] + c5 * (1.0 - s[0]),
            s[1] + c5 * (1.0 - s[1]),
            s[2] + c5 * (1.0 - s[2]))


# ---------------------------------------------------------------------------
# microfacet distributions (twin: bxdf/microfacet.py)
# ---------------------------------------------------------------------------

def roughness_to_alpha(roughness):
    x = torch.log(_max(roughness, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def _d_beckmann(wh, ax, ay):
    cos2 = cos2_theta(wh)
    tan2 = tan2_theta(wh)
    cos2p = cos2_phi(wh)
    sin2p = sin2_phi(wh)
    expo = _max(-tan2 * (cos2p / (ax * ax) + sin2p / (ay * ay)), -60.0)
    val = torch.exp(expo) / _max(PI * ax * ay * cos2 * cos2, 1e-30)
    return W(torch.isfinite(val), val, 0.0)


def _d_trowbridge(wh, ax, ay):
    cos2 = cos2_theta(wh)
    tan2 = tan2_theta(wh)
    cos2p = cos2_phi(wh)
    sin2p = sin2_phi(wh)
    last = _min(1.0 + tan2 * (cos2p / (ax * ax) + sin2p / (ay * ay)),
                1e15)
    val = 1.0 / _max(PI * ax * ay * cos2 * cos2 * last * last, 1e-30)
    return W(torch.isfinite(tan2) & torch.isfinite(val), val, 0.0)


def mf_distribution(dist, wh, ax, ay, dists=None):
    if dists is not None and tuple(dists) == (D_BECKMANN,):
        return _d_beckmann(wh, ax, ay)
    if dists is not None and tuple(dists) == (D_TROWBRIDGE,):
        return _d_trowbridge(wh, ax, ay)
    return W(dist == D_BECKMANN, _d_beckmann(wh, ax, ay),
             _d_trowbridge(wh, ax, ay))


def _sqrt_nz(x):
    """sqrt whose derivative stays finite at x == 0 (double where; the
    value is sqrt(x) everywhere, 0 at 0)."""
    zero = x == 0.0
    return W(zero, 0.0, torch.sqrt(W(zero, 1.0, x)))


def _lambda_beckmann(w, ax, ay):
    tant = torch.abs(tan_theta(w))
    alpha = _sqrt_nz(cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay)
    a = 1.0 / _max(alpha * tant, 1e-20)
    poly = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    val = W(a >= 1.6, 0.0, poly)
    return W(torch.isfinite(tant), val, 0.0)


def _lambda_trowbridge(w, ax, ay):
    tabs = torch.abs(tan_theta(w))
    alpha = _sqrt_nz(cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay)
    term = _min(alpha * tabs, 1e15)
    val = 0.5 * (-1.0 + torch.sqrt(1.0 + term * term))
    return W(torch.isfinite(tabs), val, 0.0)


def mf_lam(dist, w, ax, ay, dists=None):
    if dists is not None and tuple(dists) == (D_BECKMANN,):
        return _lambda_beckmann(w, ax, ay)
    if dists is not None and tuple(dists) == (D_TROWBRIDGE,):
        return _lambda_trowbridge(w, ax, ay)
    return W(dist == D_BECKMANN, _lambda_beckmann(w, ax, ay),
             _lambda_trowbridge(w, ax, ay))


def mf_visible(dist, w, ax, ay, dists=None):
    return 1.0 / (1.0 + mf_lam(dist, w, ax, ay, dists))


def mf_visible_both(dist, w0, w1, ax, ay, dists=None):
    return 1.0 / (1.0 + mf_lam(dist, w0, ax, ay, dists)
                  + mf_lam(dist, w1, ax, ay, dists))


def mf_pdf_wh(dist, wo, wh, ax, ay, dists=None):
    return (mf_distribution(dist, wh, ax, ay, dists)
            * mf_visible(dist, wo, ax, ay, dists)
            * torch.abs(vdot(wo, wh))
            / _max(torch.abs(cos_theta(wo)), 1e-20))


def erf(x):
    sign = torch.sign(x)
    x = torch.abs(x)
    a1, a2, a3 = 0.254829592, -0.28449673, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    t = 1.0 / (1.0 + p * x)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * torch.exp(-x * x)
    return sign * y


def erf_inv(x):
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))
    w_lo = w - 2.5
    p_lo = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164,
              0.246640727, 1.50140941):
        p_lo = c + p_lo * w_lo
    w_hi = torch.sqrt(_max(w, 1e-6)) - 3.0
    p_hi = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682):
        p_hi = c + p_hi * w_hi
    return W(w < 5.0, p_lo, p_hi) * x


def acos_pos(x):
    x = torch.clamp(x, 0.0, 1.0)
    p = -0.0187293
    for c in (0.0742610, -0.2121144, 1.5707288):
        p = c + p * x
    return p * torch.sqrt(1.0 - x)


def _sample_wh_beckmann(wo, u, ax, ay):
    """Twin: microfacet._sample_wh_beckmann (Newton solve, 9 fixed
    iterations as in the component form)."""
    wo_st = vnormalize((ax * wo[0], ay * wo[1], wo[2]))
    cos_t = torch.abs(cos_theta(wo_st))
    ux, uy = u

    r_n = torch.sqrt(_max(-torch.log(_max(ux, 1e-20)), 0.0))
    phi_n = 2.0 * PI * uy
    sx_n = r_n * torch.cos(phi_n)
    sy_n = r_n * torch.sin(phi_n)

    cos_ts = torch.clamp(cos_t, 1e-6, 0.9999)
    sin_t = torch.sqrt(_max(1.0 - cos_ts * cos_ts, 0.0))
    tan_t = sin_t / cos_ts
    cot_t = cos_ts / _max(sin_t, 1e-12)
    uxs = _max(ux, 1e-6)
    theta = acos_pos(cos_ts)
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    sqrt_pi_inv = 1.0 / math.sqrt(PI)
    c0 = erf(cot_t)
    b = c0 - (1.0 + c0) * _max(1.0 - uxs, 1e-10) ** fit
    norm = 1.0 / (1.0 + c0 + sqrt_pi_inv * tan_t
                  * torch.exp(-cot_t * cot_t))

    a_, b_, c_ = torch.full_like(b, -1.0), b, c0
    for _ in range(9):
        b2 = W((b_ < a_) | (b_ > c_), 0.5 * (a_ + c_), b_)
        inv = erf_inv(b2)
        value = norm * (1.0 + b2 + sqrt_pi_inv * tan_t
                        * torch.exp(-inv * inv)) - uxs
        deriv = norm * (1.0 - inv * tan_t)
        c_new = W(value > 0.0, b2, c_)
        a_new = W(value > 0.0, a_, b2)
        b_new = b2 - value / W(deriv == 0.0, 1.0, deriv)
        done = torch.abs(value) < 1e-5
        a_, b_, c_ = (W(done, a_, a_new), W(done, b2, b_new),
                      W(done, c_, c_new))
    sx_g = erf_inv(b_)
    sy_g = erf_inv(2.0 * _max(uy, 1e-6) - 1.0)

    near = cos_t > 0.9999
    sx = W(near, sx_n, sx_g)
    sy = W(near, sy_n, sy_g)

    cphi = cos_phi(wo_st)
    sphi = sin_phi(wo_st)
    sx, sy = cphi * sx - sphi * sy, sphi * sx + cphi * sy
    sx = sx * ax
    sy = sy * ay
    wh = vnormalize((-sx, -sy, torch.ones_like(sx)))
    return vscale(wh, torch.sign(wo[2]))


def _sample_wh_trowbridge_oneside(wo, u, ax, ay):
    """Twin: microfacet._sample_wh_trowbridge_oneside (sqrt form)."""
    wo_st = vnormalize((ax * wo[0], ay * wo[1], wo[2]))
    cos_t = torch.abs(cos_theta(wo_st))
    ux, uy = u

    r_n = torch.sqrt(ux / _max(1.0 - ux, 1e-20))
    phi_n = 2.0 * PI * uy
    sx_n = r_n * torch.cos(phi_n)
    sy_n = r_n * torch.sin(phi_n)

    cos_ts = torch.clamp(cos_t, 1e-6, 0.9999)
    sin_t = torch.sqrt(_max(1.0 - cos_ts * cos_ts, 0.0))
    tan_t = sin_t / cos_ts
    cot_t = cos_ts / _max(sin_t, 1e-12)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (cot_t * cot_t)))
    a = 2.0 * uy / g1 - 1.0
    denom = a * a - 1.0
    tmp = _min(1.0 / W(denom == 0.0, 1e-20, denom), 1e10)
    d = torch.sqrt(_max(
        tan_t * tan_t * tmp * tmp - (a * a - tan_t * tan_t) * tmp, 0.0))
    sx1 = tan_t * tmp - d
    sx2 = tan_t * tmp + d
    sx_g = W((a < 0.0) | (sx2 > cot_t), sx1, sx2)

    s = W(uy > 0.5, 1.0, -1.0)
    uy2 = W(uy > 0.5, 2.0 * (uy - 0.5), 2.0 * (0.5 - uy))
    z = (uy2 * (uy2 * (uy2 * 0.27385 - 0.73369) + 0.46341)) / (
        uy2 * (uy2 * (uy2 * 0.093073 + 0.309420) - 1.0) + 0.597999)
    if TR_COMPAT_NO_SQRT:
        sy_g = s * z * (1.0 + sx_g * sx_g)
    else:
        sy_g = s * z * torch.sqrt(1.0 + sx_g * sx_g)

    near = cos_t > 0.9999
    sx = W(near, sx_n, sx_g)
    sy = W(near, sy_n, sy_g)

    cphi = cos_phi(wo_st)
    sphi = sin_phi(wo_st)
    sx, sy = cphi * sx - sphi * sy, sphi * sx + cphi * sy
    sx = sx * ax
    sy = sy * ay
    return vnormalize((-sx, -sy, torch.ones_like(sx)))


def _sample_wh_trowbridge(wo, u, ax, ay):
    flip = wo[2] < 0.0
    won = vwhere(flip, vneg(wo), wo)
    wh = _sample_wh_trowbridge_oneside(won, u, ax, ay)
    return vwhere(flip, vneg(wh), wh)


def mf_sample_wh(dist, wo, u, ax, ay, dists=None):
    if dists is not None and tuple(dists) == (D_BECKMANN,):
        return _sample_wh_beckmann(wo, u, ax, ay)
    if dists is not None and tuple(dists) == (D_TROWBRIDGE,):
        return _sample_wh_trowbridge(wo, u, ax, ay)
    return vwhere(dist == D_BECKMANN,
                  _sample_wh_beckmann(wo, u, ax, ay),
                  _sample_wh_trowbridge(wo, u, ax, ay))


# ---------------------------------------------------------------------------
# slot-table BSDF in component form (twin: bxdf/slots.py)
# ---------------------------------------------------------------------------

class CSlots:
    """Component-form BsdfSlots: per-slot lists of lane tensors.
    present: per-column sets of type ids (host-static), dists: the
    per-family microfacet-model sets (host-static)."""

    __slots__ = ("ns", "ts", "bs", "ng", "eta", "type", "kind",
                 "c0", "c1", "p0", "p1", "p2", "dist",
                 "present", "dists")

    def __init__(self, ns, ts, bs, ng, eta, type, kind, c0, c1,
                 p0, p1, p2, dist, present=None, dists=None):
        self.ns = ns
        self.ts = ts
        self.bs = bs
        self.ng = ng
        self.eta = eta
        self.type = type
        self.kind = kind
        self.c0 = c0
        self.c1 = c1
        self.p0 = p0
        self.p1 = p1
        self.p2 = p2
        self.dist = dist
        self.present = present
        self.dists = dists

    @property
    def nslots(self):
        return len(self.type)

    def col_present(self, k: int):
        if self.present is None:
            return None
        return self.present[k]

    def any_present(self):
        if self.present is None:
            return None
        out = set()
        for c in self.present:
            out |= set(c)
        return tuple(sorted(out))


def _fam_dists(dist_sets, *types):
    if dist_sets is None:
        return None
    out = set()
    for t, ds in dist_sets:
        if t in types:
            out |= set(ds)
    return tuple(sorted(out)) if out else None


def _fin(x):
    return torch.clamp(x, -_FMAX, _FMAX)


def make_bsdf_frame(ns, ng, dpdu):
    """Twin: slots.make_bsdf_frame."""
    t = vsub(dpdu, vscale(ns, vdot(ns, dpdu)))
    bad = vlength2(t) < 1e-12
    fb_u, _ = get_basis_from(ns)
    t = vnormalize(vwhere(bad, fb_u, t))
    b = vnormalize(vcross(ns, t))
    return t, b


def match_count(b: CSlots, types: int = ALL):
    cnt = torch.zeros_like(b.type[0])
    for k in range(b.nslots):
        cnt = cnt + ((b.kind[k] & types) != 0).to(cnt.dtype)
    return cnt


def _oren_nayar_eval(c0, p0, p1, wo, wi):
    sin_ti = sin_theta(wi)
    sin_to = sin_theta(wo)
    sin_pi_ = sin_phi(wi)
    sin_po = sin_phi(wo)
    cos_pi_ = cos_phi(wi)
    cos_po = cos_phi(wo)
    dcos = cos_pi_ * cos_po + sin_pi_ * sin_po
    max_cos = W((sin_ti > 1e-4) | (sin_to > 1e-4), _max(dcos, 0.0), 0.0)
    ci = torch.abs(cos_theta(wi))
    co = torch.abs(cos_theta(wo))
    sin_a = W(ci > co, sin_to, sin_ti)
    tan_b = _min(W(ci > co, sin_ti / _max(ci, 1e-12),
                   sin_to / _max(co, 1e-12)), 1e4)
    s = INV_PI * (p0 + p1 * max_cos * sin_a * tan_b)
    return vscale(c0, s)


def _cos_pdf_same(wo, wi):
    return W(wo[2] * wi[2] > 0.0, torch.abs(cos_theta(wi)) * INV_PI, 0.0)


def _cos_pdf_opposite(wo, wi):
    return W(wo[2] * wi[2] >= 0.0, 0.0, torch.abs(cos_theta(wi)) * INV_PI)


def _ts_r_eval(c0, alpha, eta0, eta1, dist, wo, wi, dists=None):
    wh = vnormalize(vadd(wo, wi))
    nanmask = ~visfinite(wh)
    d = mf_distribution(dist, wh, alpha, alpha, dists)
    g = mf_visible_both(dist, wo, wi, alpha, alpha, dists)
    fr = fresnel_dielectric(vdot(wi, wh), eta0, eta1)
    denom = 4.0 * torch.abs(wo[2]) * torch.abs(wi[2])
    s = _fin(d * g * fr / _max(denom, 1e-20))
    return vwhere(nanmask, vzero_like(s), vscale(c0, s))


def _ts_t_eval(c0, alpha, eta0, eta1, dist, wo, wi, dists=None):
    same_side = wo[2] * wi[2] > 0.0
    eta = W(wo[2] > 0.0, _csafe_ratio(eta1, eta0),
            _csafe_ratio(eta0, eta1))
    wh = vnormalize(vadd(wo, vscale(wi, eta)))
    wh_bad = ~visfinite(wh)
    wh = vwhere(wh[2] < 0.0, vneg(wh), wh)
    cosoh = vdot(wo, wh)
    fr = fresnel_dielectric(cosoh, eta0, eta1)
    cosih = vdot(wi, wh)
    sqrt_denom = cosoh + eta * cosih
    d = mf_distribution(dist, wh, alpha, alpha, dists)
    g = mf_visible_both(dist, wo, wi, alpha, alpha, dists)
    denom = (torch.abs(cos_theta(wo)) * torch.abs(cos_theta(wi))
             * sqrt_denom * sqrt_denom)
    s = _fin(d * g * (1.0 - fr) * torch.abs(cosih) * torch.abs(cosoh)
             / _max(denom, 1e-20))
    val = vscale(c0, s)
    one = torch.ones_like(s)
    val = vwhere(wh_bad, (one, one, one), val)
    return vwhere(same_side, vzero_like(s), val)


def _ashikhmin_eval(c0, c1, alpha, dist, wo, wi, dists=None):
    wh_raw = vadd(wo, wi)
    degen = vlength2(wh_raw) < 1e-12
    one = torch.ones_like(wh_raw[0])
    wh = vnormalize(vwhere(degen, (one, 0.0 * one, 0.0 * one), wh_raw))
    term_o = 1.0 - (1.0 - 0.5 * torch.abs(cos_theta(wo))) ** 5
    term_i = 1.0 - (1.0 - 0.5 * torch.abs(cos_theta(wi))) ** 5
    dsc = (28.0 / (23.0 * PI)) * (term_o * term_i)
    diffuse = (c0[0] * (1.0 - c1[0]) * dsc,
               c0[1] * (1.0 - c1[1]) * dsc,
               c0[2] * (1.0 - c1[2]) * dsc)
    d = mf_distribution(dist, wh, alpha, alpha, dists)
    cosih = vdot(wi, wh)
    denom = 4.0 * torch.abs(cosih) * torch.maximum(
        torch.abs(cos_theta(wi)), torch.abs(cos_theta(wo)))
    sd = _fin(d / _max(denom, 1e-20))
    sf = schlick_fresnel(cosih, c1)
    spec = vscale(sf, sd)
    return vwhere(degen, vzero_like(sd), vadd(diffuse, spec))


def _ts_r_eval_pdf(c0, alpha, eta0, eta1, dist, wo, wi, dists=None):
    wh = vnormalize(vadd(wo, wi))
    nanmask = ~visfinite(wh)
    d = mf_distribution(dist, wh, alpha, alpha, dists)
    g = mf_visible_both(dist, wo, wi, alpha, alpha, dists)
    fr = fresnel_dielectric(vdot(wi, wh), eta0, eta1)
    denom = 4.0 * torch.abs(wo[2]) * torch.abs(wi[2])
    s = _fin(d * g * fr / _max(denom, 1e-20))
    f = vwhere(nanmask, vzero_like(s), vscale(c0, s))
    pdf = d * mf_visible(dist, wo, alpha, alpha, dists) \
        * torch.abs(vdot(wo, wh)) \
        / _max(torch.abs(cos_theta(wo)), 1e-20) \
        / (4.0 * vdot(wo, wh))
    pdf = W(torch.isfinite(pdf), pdf, 0.0)
    pdf = W(wo[2] * wi[2] <= 0.0, 0.0, pdf)
    return f, pdf


def _ts_t_eval_pdf(c0, alpha, eta0, eta1, dist, wo, wi, dists=None):
    same_side = wo[2] * wi[2] > 0.0
    eta = W(wo[2] > 0.0, _csafe_ratio(eta1, eta0),
            _csafe_ratio(eta0, eta1))
    wh = vnormalize(vadd(wo, vscale(wi, eta)))
    wh_bad = ~visfinite(wh)
    whp = vwhere(wh[2] < 0.0, vneg(wh), wh)
    cosoh = vdot(wo, whp)
    fr = fresnel_dielectric(cosoh, eta0, eta1)
    cosih = vdot(wi, whp)
    sqrt_denom = cosoh + eta * cosih
    d = mf_distribution(dist, whp, alpha, alpha, dists)
    g = mf_visible_both(dist, wo, wi, alpha, alpha, dists)
    denom = (torch.abs(cos_theta(wo)) * torch.abs(cos_theta(wi))
             * sqrt_denom * sqrt_denom)
    s = _fin(d * g * (1.0 - fr) * torch.abs(cosih) * torch.abs(cosoh)
             / _max(denom, 1e-20))
    val = vscale(c0, s)
    one = torch.ones_like(s)
    val = vwhere(wh_bad, (one, one, one), val)
    f = vwhere(same_side, vzero_like(s), val)
    cosoh_u = vdot(wo, wh)
    cosih_u = vdot(wi, wh)
    sqd_u = cosoh_u + eta * cosih_u
    dhdi = eta * eta * torch.abs(cosih_u) / _max(sqd_u * sqd_u, 1e-20)
    d_u = mf_distribution(dist, wh, alpha, alpha, dists)
    pdf = d_u * mf_visible(dist, wo, alpha, alpha, dists) \
        * torch.abs(cosoh_u) \
        / _max(torch.abs(cos_theta(wo)), 1e-20) * dhdi
    pdf = W(wh_bad, 1.0, pdf)
    pdf = W(wo[2] * wi[2] > 0.0, 0.0, pdf)
    return f, pdf


def _ashikhmin_eval_pdf(c0, c1, alpha, dist, wo, wi, dists=None):
    f = _ashikhmin_eval(c0, c1, alpha, dist, wo, wi, dists)
    wh_p = vnormalize(vadd(wo, wi))
    p = mf_distribution(dist, wh_p, alpha, alpha, dists) \
        * mf_visible(dist, wo, alpha, alpha, dists) \
        * torch.abs(vdot(wo, wh_p)) \
        / _max(torch.abs(cos_theta(wo)), 1e-20) \
        / (4.0 * vdot(wo, wh_p))
    p = W(torch.isfinite(p), p, 0.0)
    pdf = 0.5 * (p + torch.abs(cos_theta(wi)) * INV_PI)
    pdf = W(wo[2] * wi[2] < 0.0, 0.0, pdf)
    return f, pdf


def _ts_t_pdf(alpha, eta0, eta1, dist, wo, wi, dists=None):
    eta = W(wo[2] > 0.0, _csafe_ratio(eta1, eta0),
            _csafe_ratio(eta0, eta1))
    wh = vnormalize(vadd(wo, vscale(wi, eta)))
    bad = ~visfinite(wh)
    sqrt_denom = vdot(wo, wh) + eta * vdot(wi, wh)
    dhdi = eta * eta * torch.abs(vdot(wi, wh)) / _max(
        sqrt_denom * sqrt_denom, 1e-20)
    pdf = mf_pdf_wh(dist, wo, wh, alpha, alpha, dists) * dhdi
    pdf = W(bad, 1.0, pdf)
    return W(wo[2] * wi[2] > 0.0, 0.0, pdf)


def _ashikhmin_pdf(alpha, dist, wo, wi, dists=None):
    wh = vnormalize(vadd(wo, wi))
    p = mf_pdf_wh(dist, wo, wh, alpha, alpha, dists) \
        / (4.0 * vdot(wo, wh))
    p = W(torch.isfinite(p), p, 0.0)
    pdf = 0.5 * (p + torch.abs(cos_theta(wi)) * INV_PI)
    return W(wo[2] * wi[2] < 0.0, 0.0, pdf)


# (alpha, eta0, eta1) a microfacet or Fresnel family is evaluated with
# on the lanes whose slot holds another family.  Every family runs on
# every lane and torch.where keeps the right one; with the other slot's
# parameters (alpha 0, eta 0) the discarded evaluation divides by zero,
# and its zero cotangent times that infinity is a NaN that reaches the
# shared inputs (wo, wi, roughness).  Finite stand-ins keep the
# backward finite (the double-where discipline of DESIGN §5); the
# selected lanes see their own parameters, so the forward is unchanged.
_SAFE_P = (0.5, 1.0, 1.5)


def _family_params(m, p0, p1, p2):
    return (W(m, p0, _SAFE_P[0]), W(m, p1, _SAFE_P[1]),
            W(m, p2, _SAFE_P[2]))


def slot_eval_pdf_fused(stype, c0, c1, p0, p1, p2, dist, wo, wi,
                        present=None, dist_sets=None):
    """Twin: slots.slot_eval_pdf_fused."""
    zero1 = torch.zeros_like(p0)
    zero3 = vzero_like(p0)
    fd = lambda *ts: _fam_dists(dist_sets, *ts)
    fams = (
        (T_LAMBERT_R, lambda m: (vscale(c0, INV_PI),
                                 _cos_pdf_same(wo, wi))),
        (T_OREN_NAYAR, lambda m: (_oren_nayar_eval(c0, p0, p1, wo, wi),
                                  _cos_pdf_same(wo, wi))),
        (T_LAMBERT_T, lambda m: (vscale(c0, INV_PI),
                                 _cos_pdf_opposite(wo, wi))),
        (T_TS_R, lambda m: _ts_r_eval_pdf(
            c0, *_family_params(m, p0, p1, p2), dist, wo, wi, fd(T_TS_R))),
        (T_TS_T, lambda m: _ts_t_eval_pdf(
            c0, *_family_params(m, p0, p1, p2), dist, wo, wi, fd(T_TS_T))),
        (T_ASHIKHMIN, lambda m: _ashikhmin_eval_pdf(
            c0, c1, _family_params(m, p0, p1, p2)[0], dist, wo, wi,
            fd(T_ASHIKHMIN))),
    )
    f_out = zero3
    p_out = zero1
    for t, fn in fams:
        if present is not None and t not in present:
            continue
        m = stype == t
        fv, pv = fn(m)
        f_out = vwhere(m, fv, f_out)
        p_out = W(m, pv, p_out)
    return f_out, p_out


def slot_sample(stype, c0, c1, p0, p1, p2, dist, wo, u, present=None,
                dist_sets=None):
    """Twin: slots.slot_sample.  u is a (ux, uy) tuple."""
    ux = u[0]
    sgv = lambda v: (v[0].detach(), v[1].detach(), v[2].detach())

    def has(*ts):
        return present is None or any(t in present for t in ts)

    table = {}
    zero1 = torch.zeros_like(ux)
    full = lambda v: torch.full_like(stype, v)

    if has(T_LAMBERT_R, T_OREN_NAYAR, T_LAMBERT_T):
        wi_cos = sgv(sample_cosw_hemisphere(u))
        wi_cos_flip = (wi_cos[0], wi_cos[1], -wi_cos[2])
        wi_same = vwhere(wo[2] < 0.0, wi_cos_flip, wi_cos)
        wi_opp = vwhere(wo[2] > 0.0, wi_cos_flip, wi_cos)
        if has(T_LAMBERT_R):
            table[T_LAMBERT_R] = (
                vscale(c0, INV_PI), wi_same, _cos_pdf_same(wo, wi_same),
                full(KIND_OF_TYPE[T_LAMBERT_R]))
        if has(T_OREN_NAYAR):
            table[T_OREN_NAYAR] = (
                _oren_nayar_eval(c0, p0, p1, wo, wi_same), wi_same,
                _cos_pdf_same(wo, wi_same),
                full(KIND_OF_TYPE[T_OREN_NAYAR]))
        if has(T_LAMBERT_T):
            table[T_LAMBERT_T] = (
                vscale(c0, INV_PI), wi_opp, _cos_pdf_opposite(wo, wi_opp),
                full(KIND_OF_TYPE[T_LAMBERT_T]))

    if has(T_FRESNEL_SPEC, T_SPECULAR_R, T_SPECULAR_T):
        cth = cos_theta(wo)
        wi_mirror = (-wo[0], -wo[1], wo[2])

    if has(T_FRESNEL_SPEC):
        q0, q1, _ = _family_params(stype == T_FRESNEL_SPEC, p0, p1, p2)
        fr = fresnel_dielectric(cth, q0, q1)
        refl = ux < fr
        f_refl = vscale(c0, _fin(fr / _max(torch.abs(cth), 1e-20)))
        pdf_refl = fr
        entering = cth > 0.0
        etai = W(entering, q0, q1)
        etao = W(entering, q1, q0)
        zsign = W(entering, 1.0, -1.0)
        zeros = torch.zeros_like(zsign)
        nrm = (zeros, zeros, zsign)
        eta_rel = _csafe_ratio(etai, etao)
        wt, ok_t = refract(wo, nrm, eta_rel.detach())
        wt = sgv(wt)
        pdf_trans = 1.0 - fr
        ft_s = _fin(eta_rel * eta_rel * pdf_trans
                    / _max(torch.abs(wt[2]), 1e-20))
        f_trans = vwhere(ok_t, vscale(c1, ft_s), vzero_like(ft_s))
        table[T_FRESNEL_SPEC] = (
            vwhere(refl, f_refl, f_trans),
            vwhere(refl, wi_mirror, wt),
            W(refl, pdf_refl, pdf_trans),
            W(refl, full(REFLECTION | SPECULAR),
              full(TRANSMISSION | SPECULAR)))

    fd = lambda *ts: _fam_dists(dist_sets, *ts)
    if has(T_TS_R, T_TS_T):
        q0, q1, q2 = _family_params((stype == T_TS_R) | (stype == T_TS_T),
                                    p0, p1, p2)
        wh_r = sgv(mf_sample_wh(dist, wo, u, q0, q0, fd(T_TS_R, T_TS_T)))
    if has(T_TS_R):
        wi_tsr = sgv(vnormalize(
            vsub(vscale(wh_r, 2.0 * vdot(wo, wh_r)), wo)))
        pdf_tsr = mf_pdf_wh(dist, wo, wh_r, q0, q0, fd(T_TS_R)) \
            / (4.0 * vdot(wo, wh_r))
        pdf_tsr = W(torch.isfinite(pdf_tsr), pdf_tsr, 0.0)
        f_tsr = vwhere(wo[2] * wi_tsr[2] <= 0.0, vzero_like(ux),
                       _ts_r_eval(c0, q0, q1, q2, dist, wo, wi_tsr,
                                  fd(T_TS_R)))
        table[T_TS_R] = (f_tsr, wi_tsr, pdf_tsr,
                         full(KIND_OF_TYPE[T_TS_R]))
    if has(T_TS_T):
        eta_tst = W(wo[2] > 0.0, _csafe_ratio(q1, q2),
                    _csafe_ratio(q2, q1))
        wi_tst, ok_tst = refract(wo, wh_r, eta_tst.detach())
        wi_tst = sgv(wi_tst)
        pdf_tst = W(ok_tst, _ts_t_pdf(q0, q1, q2, dist, wo, wi_tst,
                                      fd(T_TS_T)), 0.0)
        f_tst = vwhere(ok_tst,
                       _ts_t_eval(c0, q0, q1, q2, dist, wo, wi_tst,
                                  fd(T_TS_T)), vzero_like(ux))
        table[T_TS_T] = (f_tst, wi_tst, pdf_tst,
                         full(KIND_OF_TYPE[T_TS_T]))

    if has(T_ASHIKHMIN):
        spec_path = ux < 0.5
        u_spec = (torch.clamp(ux * 2.0, 0.0, 0.999999), u[1])
        u_diff = (torch.clamp((1.0 - ux) * 2.0, 0.0, 0.999999), u[1])
        a0, _, _ = _family_params(stype == T_ASHIKHMIN, p0, p1, p2)
        wh_a = sgv(mf_sample_wh(dist, wo, u_spec, a0, a0,
                                fd(T_ASHIKHMIN)))
        wi_as = sgv(vnormalize(
            vsub(vscale(wh_a, 2.0 * vdot(wo, wh_a)), wo)))
        wi_ad_raw = sample_cosw_hemisphere(u_diff)
        wi_ad = vwhere(wi_ad_raw[2] < 0.0,
                       (wi_ad_raw[0], wi_ad_raw[1], -wi_ad_raw[2]),
                       wi_ad_raw)
        wi_ash = sgv(vwhere(spec_path, wi_as, wi_ad))
        bad_spec = spec_path & (wo[2] * wi_ash[2] <= 0.0)
        pdf_ash = _ashikhmin_pdf(a0, dist, wo, wi_ash, fd(T_ASHIKHMIN))
        f_ash = vwhere(bad_spec, vzero_like(ux),
                       _ashikhmin_eval(c0, c1, a0, dist, wo, wi_ash,
                                       fd(T_ASHIKHMIN)))
        table[T_ASHIKHMIN] = (f_ash, wi_ash, pdf_ash,
                              full(KIND_OF_TYPE[T_ASHIKHMIN]))

    if has(T_SPECULAR_R, T_SPECULAR_T):
        cos_r = cos_theta(wi_mirror)
        s0, s1, _ = _family_params(
            (stype == T_SPECULAR_R) | (stype == T_SPECULAR_T), p0, p1, p2)
        fr_sr = fresnel_dielectric(cos_r, s0, s1)
        inv_c = _fin(1.0 / _max(torch.abs(cos_r), 1e-20))
        if has(T_SPECULAR_R):
            table[T_SPECULAR_R] = (
                vscale(c0, fr_sr * inv_c), wi_mirror,
                torch.ones_like(ux), full(KIND_OF_TYPE[T_SPECULAR_R]))
        if has(T_SPECULAR_T):
            table[T_SPECULAR_T] = (
                vscale(c0, (1.0 - fr_sr) * inv_c), wi_mirror,
                torch.ones_like(ux), full(KIND_OF_TYPE[T_SPECULAR_T]))

    fv = vzero_like(ux)
    wiv = (zero1, torch.ones_like(ux), zero1)
    pv = torch.zeros_like(ux)
    kv = torch.zeros_like(stype)
    for t, (f_, wi_, p_, k_) in table.items():
        m = stype == t
        fv = vwhere(m, f_, fv)
        wiv = vwhere(m, wi_, wiv)
        pv = W(m, p_, pv)
        kv = W(m, k_, kv)
    return fv, wiv, pv, kv


def bsdf_eval_pdf(b: CSlots, wow, wiw, types: int = ALL):
    """Twin: slots.bsdf_eval_pdf."""
    wo = vnormalize(to_local(b.ts, b.bs, b.ns, wow))
    wi = vnormalize(to_local(b.ts, b.bs, b.ns, wiw))
    is_refl = vdot(wow, b.ng) * vdot(wiw, b.ng) > 0.0
    f = vzero_like(wow[0])
    total = torch.zeros_like(wow[0])
    count = torch.zeros_like(b.type[0])
    for k in range(b.nslots):
        pres = b.col_present(k)
        if pres is not None and len(pres) == 0:
            continue
        kindk = b.kind[k]
        m = (kindk & types) != 0
        sel = m & ((is_refl & ((kindk & REFLECTION) != 0))
                   | (~is_refl & ((kindk & TRANSMISSION) != 0)))
        fk, pk = slot_eval_pdf_fused(
            b.type[k], b.c0[k], b.c1[k], b.p0[k], b.p1[k], b.p2[k],
            b.dist[k], wo, wi, present=pres, dist_sets=b.dists)
        f = vadd(f, vwhere(sel, fk, vzero_like(pk)))
        total = total + W(m, _max(pk, 0.0), 0.0)
        count = count + m.to(count.dtype)
    pdf = W(count > 0, total / _max(count, 1), total)
    pdf = W(wo[2] == 0.0, 0.0, pdf)
    return f, pdf


def bsdf_sample(b: CSlots, wow, u, types: int = ALL):
    """Twin: slots.bsdf_sample.  u = (ux, uy)."""
    nmatch = match_count(b, types)
    wo = vnormalize(to_local(b.ts, b.bs, b.ns, wow))

    idx = torch.minimum((u[0] * nmatch.to(torch.float32)).to(nmatch.dtype),
                        _max(nmatch - 1, 0))
    running = torch.zeros_like(idx)
    sel_k = torch.zeros_like(idx)
    for k in range(b.nslots):
        m = (b.kind[k] & types) != 0
        hit_here = m & (running == idx)
        sel_k = W(hit_here, k, sel_k)
        running = running + m.to(running.dtype)

    def take(cols):
        out = cols[0]
        for k in range(1, b.nslots):
            out = W(sel_k == k, cols[k], out)
        return out

    def take3(cols):
        out = cols[0]
        for k in range(1, b.nslots):
            out = vwhere(sel_k == k, cols[k], out)
        return out

    stype = take(b.type)
    f, wi, pdf, skind = slot_sample(
        stype, take3(b.c0), take3(b.c1), take(b.p0), take(b.p1),
        take(b.p2), take(b.dist), wo, u, present=b.any_present(),
        dist_sets=b.dists)
    skind = skind & types
    is_spec = (take(b.kind) & SPECULAR) != 0

    wiw = to_world(b.ts, b.bs, b.ns, wi)

    if b.present is not None and \
            sum(1 for c in b.present if len(c) > 0) <= 1:
        dead = (nmatch == 0) | (pdf == 0.0)
        f_out = vwhere(dead, vzero_like(pdf), f)
        pdf_out = W(dead, 0.0, pdf)
        skind = W(dead, 0, skind)
        return f_out, wiw, pdf_out, skind
    multi = (nmatch > 1) & ~is_spec
    is_refl = vdot(wow, b.ng) * vdot(wiw, b.ng) > 0.0
    f_acc = vzero_like(pdf)
    pdf_acc = torch.zeros_like(pdf)
    for k in range(b.nslots):
        pres = b.col_present(k)
        if pres is not None and len(pres) == 0:
            continue
        kindk = b.kind[k]
        sel = ((kindk & skind) != 0) & (
            (is_refl & ((kindk & REFLECTION) != 0))
            | (~is_refl & ((kindk & TRANSMISSION) != 0)))
        fk, pk = slot_eval_pdf_fused(
            b.type[k], b.c0[k], b.c1[k], b.p0[k], b.p1[k], b.p2[k],
            b.dist[k], wo, wi, present=pres, dist_sets=b.dists)
        f_acc = vadd(f_acc, vwhere(sel, fk, vzero_like(pk)))
        pdf_acc = pdf_acc + W(sel, _max(pk, 0.0), 0.0)
    f_out = vwhere(multi, f_acc, f)
    pdf_out = W(multi, pdf_acc / _max(nmatch.to(torch.float32), 1.0), pdf)

    dead = (nmatch == 0) | (pdf == 0.0)
    f_out = vwhere(dead, vzero_like(pdf), f_out)
    pdf_out = W(dead, 0.0, pdf_out)
    skind = W(dead, 0, skind)
    return f_out, wiw, pdf_out, skind
