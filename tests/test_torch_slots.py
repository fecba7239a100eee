"""The slot sweeps (kernels K8 and K9) against the JAX package: the
port's plain versions (bxdf/slots.py) and their kernel entries
(bxdf/slot_shade.py, which run the plain versions on CPU tensors)
against pallas_shade.bsdf_sample / bsdf_eval_pdf in interpret mode and
against slots.* of the JAX package, on the inputs of its
tests/test_pallas_shade.py (the five material recipes, grazing wo with
total internal reflection on glass, a single-recipe table whose slot
presence prunes the other families; the kind sets ALL and
ALL_NON_SPECULAR).  Their backward against jax.vjp of slots.*, and the
entries' autograd.Function (the fields and the recipe order handed to
the launch, its outputs, the replayed backward) with a plain stand-in
for the kernel launch.  The CUDA kernels are held
against the plain versions on the card in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arendur_tpu import materials as jm
from arendur_tpu.bxdf import pallas_shade as jps
from arendur_tpu.bxdf import slots as jsl
from arendur_tpu_torch.bxdf import slot_shade as ssh
from arendur_tpu_torch.bxdf import slots as sl
from arendur_tpu_torch.bxdf.types import ALL, ALL_NON_SPECULAR
from arendur_tpu_torch.kernels import ops
from arendur_tpu_torch.render import fuzz

torch.set_num_threads(2)

N = 1024
RTOL = ATOL = 2e-4
ELEM_GATE = 0.999      # share of elements within RTOL / ATOL
GRAD_TOL = 1e-3        # the JAX package's vjp gate (test_pallas_shade.py)

CASES = {
    "recipes": dict(),
    "grazing": dict(grazing=True, rows=fuzz.SLOT_ROWS[3:4]),
    "presence": dict(rows=fuzz.SLOT_ROWS[0:1]),
}


def _jax_bsdf(inp):
    table = jm.make_material_table(inp["rows"])
    ns = jnp.asarray(inp["ns"])
    return jm.compute_scattering(table, jnp.asarray(inp["mat_id"]), ns, ns,
                                 jnp.asarray(inp["dpdu"]))


def _close(a, b, name, alt=None):
    """At least ELEM_GATE of the elements of a within RTOL / ATOL of b.
    With alt (the JAX package's other path on the same inputs), an
    element also passes where a is no farther from b than alt is: on
    grazing glass lanes f = F / |cos| reaches ~1e5 and the Pallas
    kernel and slots.* of the JAX package differ there by up to 0.54 %
    (my CPU run), so those lanes are budgeted by JAX's own split."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ok = np.isclose(a, b, rtol=RTOL, atol=ATOL)
    if alt is not None:
        alt = np.asarray(alt, np.float64)
        ok |= np.abs(a - b) <= np.abs(alt - b) + ATOL + RTOL * np.abs(b)
    assert ok.mean() >= ELEM_GATE, (name, ok.mean(),
                                    float(np.nanmax(np.abs(a - b))))


@pytest.mark.parametrize("case,types", [
    ("recipes", ALL), ("recipes", ALL_NON_SPECULAR), ("grazing", ALL),
    ("presence", ALL)])
def test_sample_matches_jax(case, types):
    inp = fuzz.fuzz_slot_inputs(N, 0, **CASES[case])
    jb = _jax_bsdf(inp)
    wo, u = jnp.asarray(inp["wo"]), jnp.asarray(inp["u"])
    ref_k = jps.bsdf_sample(jb, wo, u, types, True)
    ref_x = jsl.bsdf_sample(jb, wo, u, types)
    b, two, tu, _ = fuzz.fuzz_slots(inp)
    if case == "presence":
        assert b.present == ((1,), (), ())
    out = ssh.bsdf_sample(b, two, tu, types)
    assert out[0].shape == (N, 3) and out[3].dtype == torch.int32
    for ref, alt in ((ref_k, ref_x), (ref_x, None)):
        for j, name in enumerate(("f", "wi", "pdf")):
            _close(out[j].numpy(), ref[j], name,
                   None if alt is None else alt[j])
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("case,types", [
    ("recipes", ALL), ("recipes", ALL_NON_SPECULAR), ("grazing", ALL)])
def test_eval_pdf_matches_jax(case, types):
    inp = fuzz.fuzz_slot_inputs(N, 5, **CASES[case])
    jb = _jax_bsdf(inp)
    wo, wi = jnp.asarray(inp["wo"]), jnp.asarray(inp["wi"])
    ref_k = jps.bsdf_eval_pdf(jb, wo, wi, types, True)
    ref_x = jsl.bsdf_eval_pdf(jb, wo, wi, types)
    b, two, _, twi = fuzz.fuzz_slots(inp)
    out = ssh.bsdf_eval_pdf(b, two, twi, types)
    for ref, alt in ((ref_k, ref_x), (ref_x, None)):
        _close(out[0].numpy(), ref[0], "f", None if alt is None else alt[0])
        _close(out[1].numpy(), ref[1], "pdf",
               None if alt is None else alt[1])


def test_frame_and_match_count_match_jax():
    inp = fuzz.fuzz_slot_inputs(N, 2)
    jb = _jax_bsdf(inp)
    b, *_ = fuzz.fuzz_slots(inp)
    np.testing.assert_array_equal(sl.match_count(b).numpy(),
                                  np.asarray(jsl.match_count(jb)))
    np.testing.assert_array_equal(
        sl.match_count(b, ALL_NON_SPECULAR).numpy(),
        np.asarray(jsl.match_count(jb, ALL_NON_SPECULAR)))
    for k in ("type", "kind", "dist"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(jb, k)))
    for k in ("ts", "bs", "c0", "c1", "p0", "p1", "p2", "eta"):
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   np.asarray(getattr(jb, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert b.present == jb.present and b.dists == jb.dists
    ts, bs = sl.make_bsdf_frame(b.ns, b.ng, torch.tensor(inp["dpdu"]))
    jts, jbs = jsl.make_bsdf_frame(jb.ns, jb.ng, jnp.asarray(inp["dpdu"]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), atol=1e-6)
    np.testing.assert_allclose(bs.numpy(), np.asarray(jbs), atol=1e-6)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

_GRAD_FIELDS = ("c0", "c1", "p0", "ns")


def _cotangents(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _jax_vjp(fn, jb, w, x, ct):
    """Cotangents of (f, pdf) = fn(b, w, x) w.r.t. _GRAD_FIELDS and w."""
    def g(fields, w_):
        f, pdf = fn(jb.replace(**dict(zip(_GRAD_FIELDS, fields))), w_, x)
        return f, pdf
    _, vjp = jax.vjp(g, tuple(getattr(jb, k) for k in _GRAD_FIELDS), w)
    (fields, dw) = vjp(tuple(jnp.asarray(c) for c in ct))
    return list(fields) + [dw]


def _port_vjp(fn, b, w, x, ct):
    leaves = [getattr(b, k).detach().clone().requires_grad_(True)
              for k in _GRAD_FIELDS]
    wl = w.detach().clone().requires_grad_(True)
    f, pdf = fn(b.replace(**dict(zip(_GRAD_FIELDS, leaves))), wl, x)
    return torch.autograd.grad(
        (f, pdf), leaves + [wl], [torch.tensor(c) for c in ct],
        allow_unused=True)


# Share of the JAX-finite ns and wo cotangent entries within GRAD_TOL.
# jax.vjp of slots.* is NaN on ~80 % of them (ROADMAP Queue 3), and
# the frame enters through ill-conditioned f32 sums on glass lanes: on
# seed 7 one lane of 52 differs by 2.6 % (my CPU run), where the two
# packages agree to 1e-7 in f64 and with a central difference.
FRAME_GRAD_GATE = 0.97


def _grad_gate(got, ref):
    for name, a, r in zip(_GRAD_FIELDS + ("w",), got, ref):
        a = np.zeros(np.shape(r)) if a is None else a.numpy()
        r = np.asarray(r)
        fin = np.isfinite(r)
        assert np.isfinite(a).all(), name
        if name in ("ns", "w"):
            ok = np.isclose(a[fin], r[fin], rtol=GRAD_TOL, atol=GRAD_TOL)
            assert ok.mean() >= FRAME_GRAD_GATE, (name, ok.mean())
        else:
            np.testing.assert_allclose(a[fin], r[fin], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("which", ["sample", "eval_pdf"])
def test_backward_matches_jax_vjp(which):
    inp = fuzz.fuzz_slot_inputs(256, 7)
    jb = _jax_bsdf(inp)
    b, wo, u, wi = fuzz.fuzz_slots(inp)
    ct = _cotangents(256, 1)
    if which == "sample":
        jfn = lambda b_, w_, x_: (lambda r: (r[0], r[2]))(
            jsl.bsdf_sample(b_, w_, x_, ALL))
        tfn = lambda b_, w_, x_: ssh.bsdf_sample(b_, w_, x_, ALL)[0::2]
        x, tx = jnp.asarray(inp["u"]), u
    else:
        jfn = lambda b_, w_, x_: jsl.bsdf_eval_pdf(b_, w_, x_, ALL)
        tfn = lambda b_, w_, x_: ssh.bsdf_eval_pdf(b_, w_, x_, ALL)
        x, tx = jnp.asarray(inp["wi"]), wi
    ref = _jax_vjp(jfn, jb, jnp.asarray(inp["wo"]), x, ct)
    _grad_gate(_port_vjp(tfn, b, wo, tx, ct), ref)


def test_kernel_entries_pack_and_replay(monkeypatch):
    """The autograd.Functions of the CUDA entries on CPU tensors, with
    a plain stand-in for the launch: the launch gets the BsdfSlots whose
    fields it reads where they lie (ops.SLOT_FIELDS, no pack), K8 also
    the BSDF's recipe order, built once and kept, K9 none; the outputs
    are the launch's tensors as they are and equal the plain versions,
    the sampled direction and kind are detached, and the replayed
    backward equals autograd over the plain version."""
    inp = fuzz.fuzz_slot_inputs(256, 11)
    b, wo, u, wi = fuzz.fuzz_slots(inp)
    launched = []

    def check(bb):
        for name, dtype, tail in ops.SLOT_FIELDS:
            t = getattr(bb, name)
            assert t.dtype == dtype and tuple(t.shape) == (256,) + tail

    def sample_launch(bb, w, x, types, order):
        check(bb)
        assert torch.equal(order, ssh.lane_order_reference(bb))
        assert order is ssh.lane_order(bb)
        launched.append(sl.bsdf_sample(bb, w, x, types))
        return launched[-1]

    def eval_launch(bb, w, x, types):
        check(bb)
        launched.append(sl.bsdf_eval_pdf(bb, w, x, types))
        return launched[-1]

    monkeypatch.setattr(ops, "slot_sample", sample_launch)
    monkeypatch.setattr(ops, "slot_eval_pdf", eval_launch)
    fields = lambda bb: [getattr(bb, k) for k in ssh._DIFF]
    ct = [torch.tensor(c) for c in _cotangents(256, 3)]
    for types in (ALL, ALL_NON_SPECULAR):
        for fn, plain, x in (
                (ssh._SampleKernel, lambda bb, w, x_: sl.bsdf_sample(
                    bb, w, x_, types), u),
                (ssh._EvalPdfKernel, lambda bb, w, x_: sl.bsdf_eval_pdf(
                    bb, w, x_, types), wi)):
            leaves = [t.clone().requires_grad_(True) for t in fields(b)]
            wl = wo.clone().requires_grad_(True)
            bl = b.replace(**dict(zip(ssh._DIFF, leaves)))
            out = fn.apply(bl, types, wl, x, *leaves)
            ref = plain(bl, wl, x)
            for a, r, raw in zip(out, ref, launched[-1]):
                assert torch.equal(a, r)
                assert a.data_ptr() == raw.data_ptr()
            if fn is ssh._SampleKernel:
                assert not out[1].requires_grad and out[0].requires_grad
            pick = (lambda r: (r[0], r[2])) if fn is ssh._SampleKernel \
                else tuple
            g = torch.autograd.grad(pick(out), leaves + [wl], ct,
                                    allow_unused=True)
            g_ref = torch.autograd.grad(pick(ref), leaves + [wl], ct,
                                        allow_unused=True)
            for a, r in zip(g, g_ref):
                assert (a is None and r is None) or torch.allclose(
                    a, r, rtol=1e-6, atol=1e-7)
