"""The row-form bounce kernel's function (kernel K7 of the JAX package,
render/pallas_bounce.py, which serves tables of more than 32 rows) in
the port: the fused bounce body of K3 reads table rows by direct index,
with no row cap, so it serves such scenes itself.  On a Cornell box
whose 9 material rows are spread over 5 copies each (45 rows,
render/fuzz.py spread_materials): the port's plain K3 body against
pallas_bounce.xla_reference (K7's oracle, row form) on fuzz lanes and on
the first bounce of a camera wave, and the 45-row render against the
9-row render.  The kernel is held against its plain version on these
lanes on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arendur_tpu.render import pallas_bounce as jpb
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.lighting import nee
from arendur_tpu_torch.render import cbounce as tcb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import sampler as smp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
ELEM_GATE = 0.999          # the K3 gate (tests/test_torch_cbounce.py)
RTOL, ATOL = 1e-4, 1e-5
FLAG_COLS = (12, 13, 16, 24)
MIN_DEPTH, RR = 4, 0.05


@pytest.fixture(scope="module")
def wide():
    s, cam, film, cfg, _ = tsd.parse_scene(CB, spp_override=4,
                                           resolution_override=(32, 24))
    sw = fuzz.spread_materials(s)
    ds = tsc.DeviceScene.build(sw, "cpu")
    st = ds.static
    args = (st.presence, st.dist_sets, st.lcidx, st.lpresent, st.emi_cols,
            MIN_DEPTH, RR, st.full_phi)
    ref = jax.jit(lambda x: jpb.xla_reference(
        x, *(jnp.asarray(t.numpy()) for t in (ds.ltab, ds.mtab, ds.stab)),
        *args))
    return dict(scene=s, wide=sw, ds=ds, ref=ref, cam=cam, film=film,
                cfg=dataclasses.replace(cfg, max_depth=3))


def _first_bounce(w, n=1024):
    ds, cfg = w["ds"], w["cfg"]
    idx = torch.arange(n)
    pid, sid = idx // 4, idx % 4
    pxy = torch.stack([(pid % 32).float(), (pid // 32).float()], -1)
    ws = smp.WaveSampler(smp.make_base_key(0), pid, sid, sample_dx=2,
                         sample_dy=2)
    from arendur_tpu_torch.filming import camera as cam
    o, d = cam.generate_rays(w["cam"], pxy + ws.film_jitter(), ws.u2(2))
    carry = tint.initial_carry(o, d, ws.keys)
    raw = tint.intersect_raw(ds, o, d)
    u_sel, u_l, u_b, u_rr = tint.bounce_draws(cfg, ws.keys, 0)
    lidx, selpdf = nee.sample_one_light(ds, u_sel)
    return tint.pack_bounce_input(carry, raw, lidx, selpdf, u_l, u_b, u_rr, 0)


@pytest.mark.parametrize("lanes", ["fuzz0", "fuzz1", "first bounce"])
def test_k3_body_matches_row_form_oracle(wide, lanes):
    ds = wide["ds"]
    assert ds.mtab.shape[0] == 45 > 32
    if lanes == "first bounce":
        xt = _first_bounce(wide)
        mat = torch.where(xt[tcb.C_IS_SPH] > 0.5,
                          ds.stab[xt[tcb.C_S_IDX].long(), 20],
                          xt[tcb.C_TROW + 24])
        assert int(mat[xt[tcb.C_HIT] > 0.5].max()) >= 36
    else:
        xt = torch.tensor(fuzz.fuzz_bounce_inputs(
            ds.ltab.numpy(), ds.mtab.numpy(), ds.stab.numpy(),
            seed=int(lanes[-1]), n=2048).T.copy())
    out = tcb.bounce_shade_t(xt, ds.ltab, ds.mtab, ds.stab, ds.static,
                             MIN_DEPTH, RR).numpy()
    ref = np.asarray(wide["ref"](jnp.asarray(xt.numpy().T))).T
    both_nan = np.isnan(out) & np.isnan(ref)
    close = np.isclose(out, ref, rtol=RTOL, atol=ATOL) | both_nan
    print(f"45-row tables, {lanes}: {close.mean():.6f} of elements close")
    assert close.mean() >= ELEM_GATE
    for j in FLAG_COLS:
        assert (out[j] == ref[j]).mean() >= ELEM_GATE, j


def test_wide_render_equals_narrow(wide):
    imgs = [tint.render(tsc.DeviceScene.build(s, "cpu"), wide["cam"],
                        wide["film"], wide["cfg"]).numpy()
            for s in (wide["scene"], wide["wide"])]
    assert imgs[0].max() > 0.05
    print(f"45-row vs 9-row render: max |diff| "
          f"{np.abs(imgs[1] - imgs[0]).max():.3e}")
    np.testing.assert_array_equal(imgs[1], imgs[0])
