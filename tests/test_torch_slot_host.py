"""The slot sweeps' per-lane code (K8 / K9, kernels/slot_shade.cu) and
their material-recipe order, built for the host by a host C++ compiler
(kernels/slot_shade_host.cpp, kernels/host_slots.py), on the fuzz sets
of render/fuzz.py: the five recipes under ALL and ALL_NON_SPECULAR,
grazing glass, a pruned (single-recipe) table, and a shuffled mix of
the recipes over several order tiles.

(a) the in-place sweeps (K8's lanes walked in the recipe order, K9's in
wave order) equal the same code over the earlier lane-major pack in
wave order, and K8 in the identity order, to the bit on every element;
(b) the order is a stable permutation that
groups equal keys, equal to the plain twin's (bxdf/slot_shade.py
lane_order_reference); (c) the sweep agrees with bxdf/slots.py
bsdf_sample / bsdf_eval_pdf within the kernels' gate: >= 99.9 % of the
elements within 2e-4, kinds equal (on these sets every element is
within it: the largest departure is 1.5e-6 of max(|plain|, 1), 1.2e-3
absolute on grazing glass, where f reaches ~1e3; the plain versions
round through PyTorch's CPU math library where the kernels run their
own polynomials).
Skips where no host C++ compiler exists.  No JAX."""

import numpy as np
import pytest
import torch

from arendur_tpu_torch.bxdf import slot_shade as ssh
from arendur_tpu_torch.bxdf import slots as sl
from arendur_tpu_torch.bxdf.types import ALL, ALL_NON_SPECULAR
from arendur_tpu_torch.kernels import host_slots
from arendur_tpu_torch.render import fuzz

torch.set_num_threads(2)

N = 1024
RTOL = ATOL = 2e-4     # the K8 / K9 gate of tests/test_torch_slots.py
ELEM_GATE = 0.999

CASES = {
    "recipes ALL": (dict(), ALL),
    "recipes ALL_NON_SPECULAR": (dict(), ALL_NON_SPECULAR),
    "grazing glass": (dict(grazing=True, rows=fuzz.SLOT_ROWS[3:4]), ALL),
    "pruned matte": (dict(rows=fuzz.SLOT_ROWS[0:1]), ALL),
    "shuffled mix": ("mix", ALL),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    got = host_slots.build(str(tmp_path_factory.mktemp("slots_host")))
    if got is None:
        pytest.skip("no host C++ compiler to build slot_shade_host.cpp")
    return got


def _set(case):
    kw, types = CASES[case]
    if kw == "mix":
        # runs of each recipe over 2,600 lanes (three order tiles, the
        # last ragged), shuffled
        inp = fuzz.fuzz_slot_inputs(2600, 5)
        rng = np.random.RandomState(6)
        inp["mat_id"] = rng.permutation(
            np.repeat(np.arange(5, dtype=np.int32), 520))
    else:
        inp = fuzz.fuzz_slot_inputs(N, 9, **kw)
    return fuzz.fuzz_slots(inp) + (types,)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_ordered_in_place_sweep_equals_packed_wave_order(lib, case):
    b, wo, u, wi, types = _set(case)
    _, order, _ = host_slots.order(lib, b)
    got8 = host_slots.sample(lib, b, wo, u, types, order)
    got9 = host_slots.eval_pdf(lib, b, wo, wi, types)
    p8 = host_slots.sweep_packed(lib, True, ssh.pack_slots(b, wo, u), types,
                                 b.present, b.dists)
    p9 = host_slots.sweep_packed(lib, False, ssh.pack_slots(b, wo, wi),
                                 types, b.present, b.dists)
    ref8 = (p8[0:3].T, p8[3:6].T, p8[6], p8[7].astype(np.int32))
    ref9 = (p9[0:3].T, p9[3])
    for g, r in zip(got8 + got9, ref8 + ref9):
        assert np.array_equal(_bits(g), _bits(r))
    # the order changes no lane's result
    identity = np.arange(order.shape[0], dtype=np.int32)
    for g, r in zip(got8, host_slots.sample(lib, b, wo, u, types, identity)):
        assert np.array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("case", list(CASES) + ["no presence sets"])
def test_order_is_a_stable_grouping_permutation(lib, case):
    b = (_set("shuffled mix")[0].replace(present=None, dists=None)
         if case == "no presence sets" else _set(case)[0])
    keys, order, nkeys = host_slots.order(lib, b)
    n = keys.shape[0]
    ref_keys = ssh.recipe_key_reference(b).numpy()
    assert np.array_equal(keys, ref_keys)
    assert nkeys == (11 ** 3 if b.present is None else int(np.prod(
        [len(p) + 1 for p in b.present])))
    assert keys.max() < nkeys
    assert np.array_equal(np.sort(order), np.arange(n))
    assert (np.diff(keys[order]) >= 0).all()
    same = np.diff(keys[order]) == 0
    assert (np.diff(order)[same] > 0).all()          # stable
    assert np.array_equal(order, ssh.lane_order_reference(b).numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_host_sweep_agrees_with_plain_versions(lib, case):
    b, wo, u, wi, types = _set(case)
    _, order, _ = host_slots.order(lib, b)
    got = host_slots.sample(lib, b, wo, u, types, order) \
        + host_slots.eval_pdf(lib, b, wo, wi, types)
    ref = [t.numpy() for t in sl.bsdf_sample(b, wo, u, types)
           + sl.bsdf_eval_pdf(b, wo, wi, types)]
    assert np.array_equal(got[3], ref[3])
    for g, r in zip(got[:3] + got[4:], ref[:3] + ref[4:]):
        close = np.isclose(g, r, rtol=RTOL, atol=ATOL) \
            | (np.isnan(g) & np.isnan(r))
        assert close.mean() >= ELEM_GATE
