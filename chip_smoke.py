"""On-card check of the PyTorch port (arendur_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the CUDA version;
  2. the build of the hand-written kernels, from the sources here, with
     ptxas's registers, stack, spills and shared memory per kernel (K3-K6
     twice: every table staged, and a table read in place), and K1 /
     K2's dynamic shared memory and blocks per SM (the same with a
     sphere table of any size), K3's and K6's with cb.json's tables and
     K3's with the 45-row box's, every table staged (with their
     registers and local memory a thread);
  3. closest hit (K1) and shadow any hit (K2) against their plain
     PyTorch versions on a 65,536-ray Cornell camera wave, random
     secondary rays with n_alive < N, and real shadow rays, and on the
     9 closest-hit and 8 any-hit queries of one 256x256, 16 spp,
     depth-8 fused wave (render/fuzz.py wave_queries, with the sphere
     table): per set, the share of lanes whose slot / blocked equal the
     plain version's (every lane is the aim, the gate K1_K2_GATE), t
     where the slots agree, and a second launch equal to the bit; per
     wave query, K1's / K2's ms by CUDA events and on the card (the
     profiler), the live rays and the bound;
  4. the bounce shade (K3) against its plain version on the first
     bounce of a real wave, on fuzz input over the Cornell tables and a
     table set that reaches every light and material branch, and on a
     compacted mid-wave set (bounce 3 of one 256x256, 16 spp, depth-8
     fused wave, render/fuzz.py wave_shades) with its live count
     n_alive (the lanes past it under the dead-lane contract of
     render/cbounce.py): equal to the bit on every lane of every set;
  5. the main path: a 64x48, 32 spp, depth-8 Cornell render through
     the kernels, held against the reference image
     (tests/data/cornell_golden_128x96.npy) and against the same render
     on the plain path; every kernel must have launched in it;
  6. throughput at 256x256, 16 spp, depth 8 (waves of 65,536 paths) on
     the kernel path and on the plain path;
  7. the bounce-shade backward (K4) against its plain version (autograd
     over the plain body): for a seeded random output cotangent on the
     four input sets of phase 4 (every live lane taped), and on the
     inputs and cotangents of the eight bounces of one kernel-path train
     step at 256x256, 16 spp, waves of 65,536 (render/fuzz.py
     train_step_bounces, with each bounce's live count), where most
     lanes take the pass-through; per set: dx agreement on the lanes
     taped and dx equal to the pass-through on the others, on the lanes
     past the live count also equal to autograd over the plain version
     (the dead-lane contract's identity VJP), table agreement, two
     launches bit-identical, the
     lanes taped against the plain twin's count (bwd_needs_body), the
     tape nodes, and K4's ms per call by CUDA events and on the card;
  8. the material-fitting train step (parallel/mesh.py): at 64x48,
     32 spp, depth 8 with kd, ks and roughness, loss and gradients of
     the kernel path (K1-K4) against the plain path; every kernel must
     have launched in that step.  Then at 256x256, 16 spp, depth 8,
     waves of 65,536, kd only, against phase 6's image: fwd+bwd paths/s
     of the kernel path and of the plain-backward path (the K1-K3
     forward, the backward by autograd over the plain body), the loss
     on one wave before and after the steps, and the device busy share
     of one kernel-path step from a torch.profiler trace, with K4's
     device time per call inside it;
  9. the textured split: the hit kernel (K5) and the split shade kernel
     (K6) against their plain versions, equal to the bit on every lane,
     on the first bounce of a real 65,536-lane textured wave (bench.py's
     checkerboard kd texture on every matte material of the Cornell
     box) and on fuzz input over the textured Cornell tables and the
     all-branches tables, and K6 on a compacted mid-wave set (bounce 3
     of the textured wave, with its live count); K5 ->
     texel lookups -> K6 against K3 on untextured fuzz lanes; their
     times by CUDA events on inputs rotated past the L2, and their
     device time from a torch.profiler trace;
 10. the textured main path: a 64x48, 32 spp, depth-8 textured Cornell
     render through the kernels against the same render on the plain
     path (K1, K2, K5 and K6 must have launched, K3 must not); then
     textured paths/s at 256x256, 16 spp, depth 8 on the kernel and
     the plain path, their ratio to phase 6's untextured rate, and the
     launches and device busy share of one textured wave from a
     torch.profiler trace;
 11. the slot sweeps: the slot-sample kernel (K8) and the eval-pdf
     kernel (K9) against their plain versions on the first composed
     bounce of a real 65,536-lane wave of the emission-textured Cornell
     box (examples/cornellbox/cb_etex.json) and on 65,536 fuzz lanes
     (the five material recipes with the kind sets ALL and
     ALL_NON_SPECULAR, grazing glass lanes, a pruned single-recipe
     table), equal to the bit on every lane through the entries (K8 in
     the BSDF's recipe order, built once, equal to its plain twin; K9
     in wave order), and K8 in the identity order equal to the bit; on
     the first bounce, by CUDA events on inputs rotated past the L2,
     the sweeps as the entries launch them, the order, the earlier
     route's raw launch on the lane-major pack, and the whole entry
     calls (BSDF in, outputs out) by the new route and by the earlier
     one (pack, launch, split), and the sweeps' device time from a
     torch.profiler trace;
 12. the composed main path on cb_etex.json: a 64x48, 32 spp, depth-8
     render through the kernels against the plain path (K1, K2, K8 and
     K9 must have launched, K3 / K5 / K6 must not); cb.json forced
     through the composed bounce against its fused render; composed
     paths/s at 256x256, 16 spp, depth 8 on the kernel and the plain
     path and their ratio to phase 6's fused rate; the launches of
     each kernel in one composed wave, and its device busy share from
     a torch.profiler trace, with K8 / K9 / the order's launches and
     device ms in that wave;
 13. the wide tables: the Cornell box with each material row copied 5
     times (45 rows, more than the 32 of the JAX package's fused
     kernel; K7 serves such tables on the TPU): K3 against its plain
     version, equal to the bit on every lane, on the first bounce of a
     real wave, on fuzz lanes and on a compacted mid-wave set (bounce 3
     of the 45-row wave, with its live count), its time on that first
     bounce, and its 64x48, 32 spp, depth-8 render against the 9-row
     render;
 14. the sphere branch of K1 / K2 (the port of the Pallas kernels'
     _sphere_best): K1 / K2 with the scene's sphere table against their
     plain versions at 65,536 rays with n_alive < N (render/fuzz.py
     sphere_rays: camera-like, secondary, aimed, surface-started,
     inside and grazing rays) on cb.json and on the all-branches scene
     (a partial sphere), each with the phi clip and without; their
     times on the main path's inputs (the camera wave, its shadow rays)
     by CUDA events on inputs rotated past the L2 and on the card by
     the profiler; K1 / K2 with a table of 2,251 spheres (cb.json with
     2,249 small ones, tools/make_cb_big_tables.py: past the 2,250 the
     kernels once held whole, five chunks now) against their plain
     versions on the same kind of rays; the tie set (render/fuzz.py
     tie_set: equal t across slots, clusters and spheres, rays past
     n_alive, period > 0 without spheres) against the plain versions on
     every lane, its winners asserted;
 15. instanced meshes on examples/cornellbox/cb_inst.json (the Cornell
     box placed 100 times by one instanced mesh, 200 spheres, no world
     triangle): on 4,096 camera rays over the frame, their first
     bounce's continuation rays (with a live count) and shadow rays, the
     world K1 / K2 with no cluster (the sphere table alone) equal to the
     plain versions on every lane with no descriptor encoded, the
     instanced K1 / K2 (one launch over the 4,096 world rays, the any
     hit from the world's flags) equal to their plain versions on every
     lane (t, local slot, instance, blocked; dead lanes miss), the
     earlier route's launches over the 100 x 4,096 lanes (period 4,096)
     equal to their plain versions and, after the argmin over the
     instances, to the instanced entries, and the whole query
     (scene.closest_hits) kernels against plain; the 64x48, 4 spp,
     depth-8 render through the kernels against the plain path; one
     64x48 train step's gradients (the whole frame, one wave) against
     the plain path's; paths/s at 256x256, 16 spp, depth 8 with no
     sphere test outside K1 / K2, one wave's launches, device busy time
     by kernel, TMA descriptor encodes, batched products (none) and
     peak device memory (also the encodes on cb.json with cb_inst's
     instances beside its world pool), and the instanced K1 / K2 per
     query on wave 0 (65,536 camera rays, the first bounce's shadow
     rays) equal to their plain versions on every lane, by CUDA events
     and on the card, against the bound and the plain version, beside
     the earlier route's period launch over the 6.55 M (instance, ray)
     lanes and its whole query (transforms and argmin included) in the
     same run, with each query's peak device memory, and the instanced
     entries' ms at each of wave 0's 17 queries beside its live rays;
 16. the Whitted and bidirectional (BPT) renderers on cb.json: on the
     sets of wave 0 of a 256x256, 16 spp, depth-8 BPT render as the
     kernel path ran it (render/fuzz.py bpt_wave_sets: 17 closest-hit
     queries of the two walks, 44 any-hit queries of the connections
     and lens rays, 17 BSDF samples, 161 fused evaluations), K1 / K2
     against their plain versions per query (the light walk's first
     query, rays started 1e-4 off the sphere lights, reported apart)
     with each query's time by CUDA events, bound and plain time, and
     K8 / K9 equal to their plain versions to the bit on every call,
     one recipe order a BSDF equal to its plain twin, timed on four
     calls each as in phase 11 (inputs rotated past the L2); the 64x48,
     8 spp, depth-8 BPT render and the 64x48, 32 spp Whitted render
     through the kernels against the plain path (K1, K2, K8, K9 must
     have launched in BPT's, K1, K2, K9 in Whitted's, no bounce shade
     in either); BPT and Whitted paths/s at 256x256, 16 spp, depth 8
     (BPT's from two timed waves where the whole frame would take more
     than 60 s); one BPT wave's launches, top-level host ops, device
     busy share and each kernel's launches and device ms, the order's
     under K8 / K9;
 17. the paths the port took over last (phase17): on phase 3's recorded
     cb.json query sets (65,536-lane waves), the BVH walk and the brute
     force against K1 / K2 without the sphere table, lane by lane (the
     triangle and t within T_RTOL of max(t, 1), or blocked; a lane whose
     other hit lies inside K1 / K2's self-hit guard counted apart, every
     disagreeing lane printed), with each query's ms by CUDA events and
     the walk's steps; the 64x48, 32 spp, depth-8 cb.json renders with
     --intersector bvh and naive through the kernels (K1 / K2 with no
     cluster, K8, K9) against the cluster render, their launches a wave
     and forward paths/s at 256x256, 16 spp, depth 8 (a whole frame where
     wave 0 says it takes at most 60 s, else wave 0's rate); a Sobol
     render (build_sobol_table(spp, 80)) through the kernels against the
     plain path and its paths/s; a 4-wave render cut after 2 waves and
     resumed from its checkpoint against the uninterrupted one; the
     composed train step on cb_etex.json (64x48, 32 spp, depth 8, kd / ks
     / roughness) and the texel gradient on bench.py's checker scene
     (64x48, 32 spp, depth 8), kernels against plain, and the composed
     fwd+bwd paths/s at 256x256 (one 65,536-lane wave after a warm step);
     each of its paths driven with every count set to 0 just before and
     read just after.
 18. several ranks (phase18), cb.json at 256x256, 16 spp, depth 8, waves
     of 65,536: in a one-rank NCCL group, render_sharded against the
     one-process render (per pixel rtol 1e-4 / atol 1e-5, the JAX test's
     gate) and sharded_train_step_fn against train_step_fn on wave 0
     (kd, ks, roughness: loss and gradients within 1e-5 relative), K1-K4
     launched, paths/s and the film's all-reduce ms a frame; two worker
     processes on the one card over gloo (parallel/distributed.py
     spawn_workers, render_multihost, gloo staging the film through the
     host) against each other (1e-7) and against the one-process render,
     their frame rates in turns with rank 0 rendering the frame alone,
     the all-reduce ms a frame from a separate synchronised render, and
     one sharded_train_step_fn step with two ranks against train_step_fn
     (1e-5, K1-K4 launched on each rank); and slots.rho_hd / rho_hh (K8)
     and bsdf_evaluate / bsdf_pdf (K9) on 65,536 fuzz lanes against the
     same functions over the plain sweeps, equal to the bit.
 19. tables past the caps (phase19; tools/make_cb_big_tables.py): cb.json
     with 2,500 small sphere lights over 48 new materials (ltab [2502,
     53], mtab [57, 16], ktab [2502, 24]), past what K1 / K2 held and K3 /
     K4 / K5 / K6 stage whole: each kernel's staging plan
     (kernels/ops.py stage_plan) beside the C entries' shared
     memory and blocks per SM; K1 / K2 at 65,536 sphere rays with a live
     count against their plain versions (K1_K2_GATE); K3, K5 (bench.py's
     checker kd) and K6 equal to their plain versions to the bit on every
     lane of wave 0's first bounce and its compacted bounce 3 (256x256, 16
     spp, depth 8), and K4 on the same sets under phase 7's rules; each
     kernel's ms by CUDA events and on the card and its bound, beside the
     same on cb.json in the same run; the 64x48, 4 spp, depth-8 render and
     one 64x48 train step, kernels against plain; Whitted (the same
     spheres unlit, 64x48, 4 spp) and BPT (BIG_BPT) against plain; and
     cb_inst's box on a 17 x 17 grid (289 instances, past the 256 rows the
     instanced kernel stages): the world and instanced K1 / K2 on 4,096
     camera rays and their shadow rays equal to their plain versions on
     every lane, and its render (BIG_GRID) against plain; each path
     driven with every count set to 0 just before and read just after.
 20. area-uniform sphere-light sampling (phase20; ARENDUR_SPHERE_THETA=
     area, shapes/sphere.py THETA_UNIFORM_COMPAT set False for the phase
     and restored to compat at its end, which its line says): the
     ShadeCfg's theta_compat word 0; phase 5's golden configuration
     through the kernels against the plain path, its distance to the
     golden within AREA_GOLDEN_RTOL of the JAX package's in that mode
     (AREA_GOLDEN) and beside phase 5's compat distance; K3, K5 and K6
     equal to their plain versions to the bit on every lane of wave 0's
     first bounce and its compacted bounce 3 (256x256, 16 spp, depth 8)
     of cb.json and of the 2,500-light scene of phase 19, and K4 on the
     same sets under phase 7's rules; K3 / K6 / K4's device ms on each
     first bounce in area mode beside compat's, on the same inputs, in
     the same run; a 64x48 train step (AREA_SPP, depth 8, kd / ks /
     roughness) against the plain path; the textured render and Whitted
     (64x48, AREA_SPP) and BPT (AREA_BPT) against the plain path; each
     path driven with every count set to 0 just before and read just
     after.
 21. a mesh of ~10^6 triangles (phase21; tools/make_big_mesh.py: cb.json
     with its short box replaced by a displaced sphere of 998,000
     triangles) loaded through parse_scene and DeviceScene.build with
     the native BVH build (native/bvh_builder.cpp): T, C and the host
     seconds of the write, the parse, build_clusters, the native BVH
     build and the upload beside the host's CPU model; the first 20,000
     triangles built by the native and the NumPy BVH builds, every array
     equal; one 256x256, 1 spp, depth-8 wave through the kernels (K1,
     K2, K3 launched, counts set to 0 just before and read just after),
     its image finite with a positive mean; K1 / K2 against their plain
     versions on 4,096-ray subsets of wave 0's camera query, first
     shadow query and first continuation query (K1_K2_GATE, T_RTOL); K1
     / K2's ms per launch on those whole queries by CUDA events and on
     the card, against the bound.
In phases 6, 8, 10, 12, 15 and 16 one kernel-path run (the timed render, one
train step) runs with the plain sphere test (shapes/sphere.py
sphere_best) patched to raise, and where no light pdf is evaluated in
PyTorch (phases 6, 8, 10, 16) the local sphere test too: no sphere test
runs outside K1 / K2 there.
Then the kernels JSON line (each kernel's launches in the run of its
main path: K1-K4 in the kernel-path train step of phase 8, K1 / K2
with a sphere table counted apart as well, K5 and K6
in phase 10's textured render, K8, K9 and their recipe order in phase
12's composed render, K7 (K3 on the wide tables) in phase 13's render, K1 / K2's
instanced launches in phase 15's 64x48 render, and for K1 / K2 / K8 /
K9 also their launches in phase 16's 64x48 BPT render and in one BPT
wave, and their ms, plain ms and bound on BPT's wave-0 sets (bpt_*);
K1-K4 also their launches in phase 18's one-rank NCCL render and train
step (sharded_*), and K1-K6 their launches past the caps (phase 19's
train step, K5 / K6 its textured wave) with their ms, device ms and
bound there (past_cap_*), K3-K6 their launches in area mode (phase
20's golden render, train step and textured render) and K3 / K4 / K6
their device ms there beside compat's (area_*), K1 / K2 their launches
in phase 21's wave and their ms, device ms and bound on its wave-0
camera / shadow query (big_mesh_*);
its ms and plain_ms, all
by CUDA events, K4's the mean per call over phase 7's eight train
bounces, K1's and K2's the mean per launch over phase 3's fused-wave
queries, the instanced rows' (the instanced entries') on phase 15's
wave-0 queries; and its
bound: the larger of the bytes it must
move over 3.35 TB/s and the operations this run's inputs need over
67 TFLOP/s of f32, the H100 SXM's data-sheet peaks (K4's: the bytes of
its lanes, all columns of a listed lane's input but only the gate
columns of the others', and of its tables, the mean over the same
bounces, K1's / K2's the mean over the same queries of the triangles
of each cluster a live ray enters before its result's t (K2: up to the
ray's first occluder) and the plain sphere branch's operations; the
instanced rows' the same over each (instance, cluster) in the
instance's frame, K2 up to the ray's first occluding instance and
nothing for a ray the world blocked); a row whose ms is below its bound
fails the run), the card line, and the result line.
Any failure raises; the exit code is then non-zero and no result line
is printed.  ``--out DIR`` also writes the measurements
(chip_smoke.json) and the kernel-path image (.npy) into DIR.
"""

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

K1_K2_GATE = 0.999       # slot / blocked agreement (share of lanes)
T_RTOL = 1e-5            # t where the slots agree
K3_GATE = 0.999          # share of elements within rtol 1e-4 / atol 1e-5
K3_RTOL, K3_ATOL = 1e-4, 1e-5
MSE_DS4_GATE = 1.7e-3    # golden gate of tests/test_golden.py
MEAN_GATE = 0.018
PLAIN_ATOL = 3e-3        # kernel path vs plain path, per pixel
MEAN_ATOL = 1e-3         # bvh / naive vs cluster render: image mean
K4_GATE = 0.999          # share of dx entries within rtol 1e-3 / atol 1e-5
K4_RTOL, K4_ATOL = 1e-3, 1e-5   # summation order differs from autograd's
TAB_GATE = 1e-3          # ||d - d_plain|| / ||d_plain||, table cotangents
GRAD_GATE = 1e-3         # train step: ||g - g_plain|| / ||g_plain||
GRAD_LR = 1e3            # the step size the gradients are read back with
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_S = 67e12       # H100 SXM f32, outside the tensor cores
L2_BYTES = 50 << 20      # H100 L2
TRI_FLOPS = 128          # K1/K2: four 16-term dot products per triangle
FORWARD_KERNELS = ("closest_hit", "any_hit", "closest_hit_spheres",
                   "any_hit_spheres", "bounce_shade")
TRAIN_KERNELS = FORWARD_KERNELS + ("bounce_shade_bwd",)
TEXTURED_KERNELS = ("closest_hit", "any_hit", "closest_hit_spheres",
                    "any_hit_spheres", "hit_shade", "shade_split")
COMPOSED_KERNELS = ("closest_hit", "any_hit", "closest_hit_spheres",
                    "any_hit_spheres", "slot_sample", "slot_eval_pdf",
                    "slot_order")
FUSED_ATOL = 2e-3        # forced composed vs fused (tests/test_pallas_shade)
SPHERE_KERNELS = ("closest_hit_spheres", "any_hit_spheres")
# phase 19's BPT render and the 289-instance grid's render: (resolution,
# spp, depth), cut to what the plain versions afford in the phase (the
# plain instanced query loops over the 289 instances, ~3 s a query)
BIG_BPT = ((64, 48), 2, 8)
BIG_GRID = ((32, 24), 1, 2)
INSTANCED_KERNELS = FORWARD_KERNELS + ("closest_hit_instanced",
                                       "any_hit_instanced")
# phase 20 (area-uniform sphere-light sampling): the JAX package's
# golden distance in that mode at phase 5's configuration (mse_ds4,
# |dmean|; tests/test_golden.py:29-32, tools/measure_theta_bias.py) and
# the share the port's may lie from it; the spp of its train step,
# textured render and Whitted render, and BPT's (resolution, spp, depth)
AREA_GOLDEN = (2.52e-3, 2.95e-2)
AREA_GOLDEN_RTOL = 0.1
AREA_SPP = 8
AREA_BPT = ((64, 48), 2, 8)
# phase 21 (tools/make_big_mesh.py): the mesh's triangles (at most), the
# wave's resolution (1 spp: one wave of 65,536 lanes) and depth, the cut
# built by both BVH builds, and the rays of each query held against the
# plain K1 / K2 (the plain cluster test loops over every cluster)
BIG_TRIS = 1_000_000
BIG_RES, BIG_DEPTH = (256, 256), 8
BIG_CUT = 20000
BIG_SUBSET = 4096


_T0 = time.perf_counter()


def _say(msg):
    print(f"{msg} [{time.perf_counter() - _T0:.0f} s]", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters=10):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def rotating(call, x):
    """A call that cycles `call` over copies of x that together hold more
    than twice the L2, so that each launch reads its input from device
    memory and not from the cache the previous launch filled."""
    copies = [x.clone() for _ in
              range(2 * L2_BYTES // (x.numel() * x.element_size()) + 2)]
    it = itertools.cycle(copies)
    return lambda: call(next(it))


def slot_rotation(b, wo, x):
    """Copies (b', wo', x') of a BSDF's fields and its per-lane inputs
    that together hold more than twice the L2 (as rotating's), each b'
    with its recipe order built and kept (bxdf/slot_shade.py
    lane_order)."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.kernels import ops
    names = [k for k, _, _ in ops.SLOT_FIELDS]
    nbytes = sum(t.numel() * t.element_size()
                 for t in [getattr(b, k) for k in names] + [wo, x])
    copies = []
    for _ in range(2 * L2_BYTES // nbytes + 2):
        bc = b.replace(**{k: getattr(b, k).detach().clone() for k in names})
        ssh.lane_order(bc)
        copies.append((bc, wo.detach().clone(), x.detach().clone()))
    return copies


def cycling(fn, copies):
    """A call of fn(*copy) over the copies in turn."""
    it = itertools.cycle(copies)
    return lambda: fn(*next(it))


def profiled(fn, key="", tries=3):
    """A torch.profiler trace of one fn() and its device events whose
    name holds `key`.  The profiler now and then hands back a trace
    without the device events of a run, so a trace that holds none is
    taken again, up to `tries` times; ([], None) if none held any."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type.name == "CUDA" and key in e.name]
        if events:
            return events, prof
    return [], None


def queued_ms(fn, iters=10):
    """Device time per call of fn() by CUDA events around `iters` calls
    that the host queues while the card sleeps, so that no launch waits
    on the host's launch work (the gaps between launches are counted)."""
    import torch
    cycles = 1 << 25
    for _ in range(4):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        host_behind = e0.query()
        torch.cuda.synchronize()
        if not host_behind:
            return e0.elapsed_time(e1) / iters
        cycles *= 4
    raise AssertionError("the host could not queue the calls ahead of "
                         "the card")


@contextlib.contextmanager
def sphere_tests_refused(local=True):
    """While the block runs, the plain version of K1 / K2's sphere branch
    (shapes/sphere.py sphere_best) raises, and with `local` also the
    local sphere test (intersect_local; the composed bounce's light pdf
    runs it in PyTorch, as the JAX package's does in XLA).  The block
    must have launched K1 and K2 with a sphere table."""
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.shapes import sphere as sph
    names = ("sphere_best", "intersect_local") if local else ("sphere_best",)
    saved = {k: getattr(sph, k) for k in names}

    def refuse(*args, **kwargs):
        raise AssertionError("a sphere test ran outside K1 / K2")
    before = [k.launches for k in (ops.CLOSEST_HIT_SPHERES,
                                   ops.ANY_HIT_SPHERES)]
    for k in names:
        setattr(sph, k, refuse)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(sph, k, v)
    after = [k.launches for k in (ops.CLOSEST_HIT_SPHERES,
                                  ops.ANY_HIT_SPHERES)]
    if min(a - b for a, b in zip(after, before)) < 1:
        raise AssertionError("K1 / K2 ran without a sphere table")


def sphere_agreement(t_k, s_k, t_p, s_p, live):
    """K1 with a sphere table against its plain version: (share of live
    lanes whose codes agree, live lanes where a sphere code on either
    side disagrees, of them sphere / triangle ties within T_RTOL, the
    largest |t - t_plain| where the codes agree, whether the t of
    agreeing sphere lanes are equal)."""
    import torch
    agree = (s_k == s_p) & live
    split = live & ((s_k <= -2) | (s_p <= -2)) & (s_k != s_p)
    tie = split & ((t_k - t_p).abs() <= T_RTOL * t_p.abs())
    both = agree & (s_k <= -2)
    hit = agree & (s_k != -1)
    err = (t_k - t_p).abs()[hit].max().item() if hit.any() else 0.0
    return (agree.sum().item() / live.sum().item(), int(split.sum()),
            int(tie.sum()), err, torch.equal(t_k[both], t_p[both]))


def bit_diff(a, b):
    """The elements of a and b that differ (NaN equals NaN)."""
    import torch
    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())


def order_err(b):
    """The largest |order - plain twin| of the recipe order kept for the
    BSDF b (bxdf/slot_shade.py ORDERS, lane_order_reference)."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    order = ssh.ORDERS.get(b)
    if order is None:
        raise AssertionError("no recipe order is kept for a sampled BSDF")
    ref = ssh.lane_order_reference(b).to(order.device)
    return float((order.long() - ref.long()).abs().max().item())


def slot_wave_text(got):
    """slot_wave_ms's (launches, device ms) as text."""
    return ", ".join(f"{k} ({c}, {t_:.4f})" for k, (c, t_) in got.items())


def kernel_ms(fn, key, iters=10):
    """Device time per launch of the kernel whose name holds `key`, from
    a torch.profiler trace of `iters` calls (CUDA events around a call
    also time the host's launch work, which a short kernel waits on),
    and beside it the same by queued_ms.  Where no trace held the kernel,
    the queued time stands for both, and a line says so."""
    fn()

    def run():
        for _ in range(iters):
            fn()
    spans, _ = profiled(run, key)
    queued = queued_ms(fn, iters)
    if not spans:
        _say(f"the profiler's traces held no {key}: its device time is "
             f"the queued-events time {queued:.4f} ms")
        return queued, queued
    return 1e-3 * sum(e.time_range.end - e.time_range.start
                      for e in spans) / len(spans), queued


def k4_device_ms(fn, iters=3):
    """Device time per call of fn(), a call of K4's wrapper: every device
    launch of `iters` calls in a torch.profiler trace, whatever its name;
    the queued-events time where no trace held any."""
    fn()

    def run():
        for _ in range(iters):
            fn()
    spans, _ = profiled(run)
    if not spans:
        queued = queued_ms(fn, iters)
        _say(f"the profiler's traces held no K4 launch: its device time is "
             f"the queued-events time {queued:.4f} ms")
        return queued
    return 1e-3 * sum(e.time_range.end - e.time_range.start
                      for e in spans) / iters


def plain_ops(fn):
    """Operations of one call of a plain PyTorch version: one per output
    element of each pointwise aten op and per input element of each
    reduction (views, copies, gathers and allocations count none).  The
    plain version takes every arm of a per-lane select that the tables
    reach, where a kernel's lane takes one, so this is an upper count
    of the kernel's operations on the same inputs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                first = out[0] if isinstance(out, (tuple, list)) else out
                self.n += first.numel()
            elif torch.Tag.reduction in func.tags:
                self.n += args[0].numel()
            return out

    with Count() as c:
        fn()
    return c.n


def sphere_ops(ktab, o, d, tmax, full_phi):
    """Operations of the plain sphere branch on the rays o, d, tmax,
    counted as the one-sphere-at-a-time loop of K1 / K2 makes them: S
    times one row's test (shapes/sphere.py intersect_local), its compare
    with the best t and the two selects.  sphere_best takes the rows in
    batches, with reductions the loop does not need, so its own count
    would depend on how it batches them."""
    import torch
    from arendur_tpu_torch.render import cmath as cm
    from arendur_tpu_torch.shapes import sphere as sph
    if ktab is None or ktab.shape[0] == 0:
        return 0
    m = ktab[0].unbind()
    oc, dc = o.unbind(-1), d.unbind(-1)
    code = torch.full(tmax.shape, -1, dtype=torch.int32, device=o.device)

    def one_row():
        hit, t, _ = sph.intersect_local(
            cm.tp16(m, oc), cm.tv16(m, dc), tmax, m[16], m[17], m[18],
            m[19], skip_phi_clip=full_phi)
        better = hit & (t < tmax)
        torch.where(better, t, tmax)
        torch.where(better, -2, code)
    return ktab.shape[0] * plain_ops(one_row)


def bound_ms(nbytes, nops):
    """The least time for this work on the card, and what bounds it."""
    tb, to = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def slab_mask(cbox, o, d, bound):
    """[N, C]: whether ray n enters cluster c's box before `bound`."""
    import torch
    inv = torch.where(d.abs() < 1e-30,
                      torch.where(d < 0, -1e30, 1e30), 1.0 / d)
    t0 = (cbox[None, :, 0:3] - o[:, None]) * inv[:, None]
    t1 = (cbox[None, :, 3:6] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tn <= tf) & (tf >= 0) & (tn <= bound[:, None])


def weight_bytes(cw, used):
    """Bytes of the weights of the clusters marked in used [C]: a query
    reads those of the clusters that some ray needs and no others."""
    return 4 * int(used.sum()) * cw.shape[1] * cw.shape[2]


def closest_work(cw, cbox, o, d, t):
    """(bytes, operations) of the clusters a closest hit with result t
    needs: the weights of each cluster that some ray enters before its
    t, and TRI_FLOPS per triangle of each (ray, cluster) pair so
    entered."""
    entered = slab_mask(cbox, o, d, t)
    return (weight_bytes(cw, entered.any(0)),
            TRI_FLOPS * (cw.shape[2] // 4) * int(entered.sum()))


def any_work(cw, cbox, o, d, tmax):
    """(bytes, operations) of the clusters an any hit needs (any_hit_need):
    the weights of each cluster that some ray needs, and TRI_FLOPS per
    triangle needed."""
    need, _, used = any_hit_need(cw, cbox, o, d, tmax)
    return weight_bytes(cw, used.any(0)), TRI_FLOPS * int(need.sum())


def any_hit_need(cw, cbox, o, d, tmax):
    """What an any hit needs of the clusters, in the one-ray loop's order
    (the clusters a ray enters before tmax ascending, each in ascending
    slot order): every triangle up to and including the ray's first
    occluder, all of every entered cluster where none occludes.  The
    occluders are the plain determinant products'
    (shapes/mxu_intersect.py).  Returns per ray the triangles needed
    [N], whether a triangle blocks it [N], and the clusters it needs
    [N, C]."""
    import torch
    from arendur_tpu_torch.shapes import mxu_intersect as mxi
    k = cw.shape[2] // 4
    entered = slab_mask(cbox, o, d, tmax)
    feats, teps = mxi.ray_features(o, d), mxi.ray_teps(o)
    lanes = torch.arange(k, device=o.device)
    upto = torch.empty(entered.shape, dtype=torch.int64, device=o.device)
    for c in range(cw.shape[0]):
        quad = feats @ cw[c]
        hit = mxi._accept(quad[:, :k], quad[:, k:2 * k], quad[:, 2 * k:3 * k],
                          quad[:, 3 * k:], tmax, teps)[0]
        upto[:, c] = torch.where(hit, lanes, k).amin(1) + 1
    stop = entered & (upto <= k)
    before = (stop.cumsum(1) - stop.long()) == 0
    used = entered & before
    return (torch.where(stop, upto, k) * used).sum(1), stop.any(1), used


def instanced_work(im, o, d, bound, result, blocked_in=None):
    """(bytes, operations) that one instanced query needs (the kernels
    line's bound): each ray's o, d and bound read, its outputs written,
    the mesh's boxes and instance table read, and the weights of each
    cluster some ray needs in some instance's frame; TRI_FLOPS per
    triangle of each (instance, cluster) whose box the ray enters in the
    instance's frame before the query's t (closest hit: result (t, slot,
    instance)), or (any hit: result blocked) per triangle the ray needs
    up to its first occluder, the instances in order, nothing for a ray
    the world blocked."""
    import torch
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    n, ni, kk = o.shape[0], im.n_instances, im.cw.shape[2] // 4
    closest = isinstance(result, tuple)
    nbytes = 4 * (7 * n + im.cbox.numel() + im.itab.numel()) \
        + (12 if closest else 1) * n + (0 if blocked_in is None else n)
    used = torch.zeros(im.cw.shape[0], dtype=torch.bool, device=o.device)
    if closest:
        pairs = 0
        for i in range(ni):
            entered = slab_mask(im.cbox, *ci.instance_frame(im.itab[i], o, d),
                                result[0])
            used |= entered.any(0)
            pairs += int(entered.sum())
        return nbytes + weight_bytes(im.cw, used), TRI_FLOPS * kk * pairs
    free = torch.ones(n, dtype=torch.bool, device=o.device) \
        if blocked_in is None else ~blocked_in
    done = torch.zeros(n, dtype=torch.bool, device=o.device)
    total = 0
    for i in range(ni):
        ol, dl = ci.instance_frame(im.itab[i], o, d)
        need, blk, needs = any_hit_need(im.cw, im.cbox, ol, dl, bound)
        live = free & ~done
        total += int(need[live].sum())
        used |= needs[live].any(0)
        done |= blk
    return nbytes + weight_bytes(im.cw, used), TRI_FLOPS * total


def wave_query_work(ds, q, result):
    """(bytes, operations) that one recorded K1 / K2 query
    (render/fuzz.py wave_queries) needs: each live ray's o, d and tmax
    read, the outputs written, the boxes and sphere table read; the
    clusters' weights and operations as closest_work counts them on the
    live rays and the result's t (closest hit), or any_work on the live
    rays that no sphere blocks (any hit); and the sphere branch's
    operations on the live rays (sphere_ops)."""
    from arendur_tpu_torch.shapes import sphere as sph
    n = q["o"].shape[0]
    na = n if q["n_alive"] is None else int(q["n_alive"])
    o, d, tm = q["o"][:na], q["d"][:na], q["tmax"][:na]
    tab = q["sph_tab"]
    nbytes = 4 * (na * 7 + n * (2 if q["kind"] == "closest" else 1)
                  + ds.cbox.numel() + (0 if tab is None else tab.numel()))
    nops = sphere_ops(tab, o, d, tm, q["full_phi"])
    if q["kind"] == "closest":
        wb, tri = closest_work(ds.cw, ds.cbox, o, d, result[0][:na])
    else:
        if tab is not None:
            free = sph.sphere_best(tab, o, d, tm, q["full_phi"])[1] == -1
            o, d, tm = o[free], d[free], tm[free]
        wb, tri = any_work(ds.cw, ds.cbox, o, d, tm)
    return nbytes + wb, nops + tri


def blocked_sum(fn, *rows, block=1 << 16):
    """fn summed over row blocks of its [N, ...] arguments (the work
    counts of an instanced mesh's [I * N] lanes, in bounded memory)."""
    return sum(fn(*(r[i:i + block] for r in rows))
               for i in range(0, rows[0].shape[0], block))


def query_call(fn, ds, q):
    """fn (a closest_hit / any_hit entry) on the recorded query q."""
    args = (ds.cw, ds.cbox, q["o"], q["d"], q["tmax"], q["n_alive"],
            q["period"], q["sph_tab"], q["full_phi"])
    return lambda: fn(*args)


def results(out):
    """A K1 / K2 entry's result as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


def wave_query_rows(ds, queries):
    """K1 / K2 on recorded wave queries (render/fuzz.py wave_queries):
    per query the share of lanes whose slot / blocked equal the plain
    version's, whether a second launch ("relaunch") and the result
    recorded with the query ("recorded") are equal to the first to the
    bit, the largest t error where the slots agree, the ms by CUDA
    events and on the card, the plain version's ms, the live rays, and
    the bytes, operations and bound of the query.  Raises where a
    query's lanes fall below K1_K2_GATE, a relaunch differs or t leaves
    T_RTOL.  Returns (rows, each query's kernel results)."""
    import torch
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    rows, outs = [], []
    for q in queries:
        closest = q["kind"] == "closest"
        call = query_call(ops.closest_hit if closest else ops.any_hit, ds, q)
        plain = query_call(ci.intersect_clusters_reference if closest
                           else ci.occluded_clusters_reference, ds, q)
        got, ref = results(call()), results(plain())
        rec = (q["t"], q["slot"]) if closest else (q["blocked"],)
        relaunch = all(torch.equal(a, b)
                       for a, b in zip(got, results(call())))
        recorded = all(torch.equal(a, b) for a, b in zip(got, rec))
        lanes = (got[-1] == ref[-1]).float().mean().item()
        err = 0.0
        if closest:
            hit = (got[1] == ref[1]) & (got[1] >= 0)
            if hit.any():
                err = (got[0] - ref[0]).abs()[hit].max().item()
                trel = ((got[0] - ref[0]).abs()[hit]
                        / ref[0].abs()[hit]).max().item()
                if trel > T_RTOL:
                    raise AssertionError(f"K1 wave query: t rel {trel}")
        n_q = q["o"].shape[0]
        row = dict(kind=q["kind"], live=n_q if q["n_alive"] is None
                   else int(q["n_alive"]), lanes_equal=lanes,
                   relaunch=relaunch, recorded=recorded, max_abs_err=err,
                   ms=time_ms(call), plain_ms=time_ms(plain, iters=1))
        row["device_ms"], row["queued_ms"] = kernel_ms(call, "cluster_kernel")
        row["bytes"], row["ops"] = wave_query_work(ds, q, got)
        row["bound_ms"] = bound_ms(row["bytes"], row["ops"])[0]
        rows.append(row)
        outs.append(got)
        if lanes < K1_K2_GATE or not relaunch:
            raise AssertionError(f"K1 / K2 on a wave query: {row}")
    return rows, outs


# the kernels instantiated twice (kernels/cbounce*.cu INPLACE): every
# table staged, or a table past the shared memory read in place
PTXAS_NAMES = {f"{k}ILb{b}E": k + (" in place" if b else "")
               for k in ("bounce_shade_bwd_kernel", "bounce_shade_kernel",
                         "hit_shade_kernel", "shade_split_kernel")
               for b in (0, 1)}


def ptxas_report(logs):
    """Registers, stack and spills of each kernel entry, from nvcc's
    -Xptxas -v output."""
    out = {}
    for log in logs:
        name = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                if name:
                    out[name] = out[name].strip("; ")
                name = next((PTXAS_NAMES.get(k, k) for k in (
                                         "bounce_shade_bwd_kernelILb0E",
                                         "bounce_shade_bwd_kernelILb1E",
                                         "bounce_shade_bwd_classify_kernel",
                                         "bounce_shade_bwd_list_kernel",
                                         "bounce_shade_bwd_partials_kernel",
                                         "bounce_shade_bwd_reduce_kernel",
                                         "bounce_shade_kernelILb0E",
                                         "bounce_shade_kernelILb1E",
                                         "hit_shade_kernelILb0E",
                                         "hit_shade_kernelILb1E",
                                         "shade_split_kernelILb0E",
                                         "shade_split_kernelILb1E",
                                         "slot_sample_kernel",
                                         "slot_eval_pdf_kernel",
                                         "slot_sample_packed_kernel",
                                         "slot_eval_pdf_packed_kernel",
                                         "slot_order_count_kernel",
                                         "slot_order_scatter_kernel",
                                         "cluster_kernelILb0E",
                                         "cluster_kernelILb1E")
                             if k in line), line.split("'")[1][:40])
                out[name] = ""
            elif name and ("Used" in line or ("stack frame" in line
                                              and not out[name])):
                out[name] += " ".join(line.replace("ptxas info    :",
                                                   "").split()) + "; "
                if "Used" in line:
                    name = None
    return {k: v.strip("; ") for k, v in out.items()}


def k4_compare(xt, tabs, ct, shade_cfg):
    """K4 on one input set against its plain version (autograd over the
    plain body), phase 7's measures: dx agreement on the lanes taped,
    dx equal to the pass-through on the others and, on the lanes past
    the live count, to the plain VJP (the dead-lane contract's
    identity), the table cotangents' relative error, a second launch
    bit-identical, the tape nodes and the lanes taped beside the plain
    twin's count (bwd_needs_body), and the largest |dx - dx_plain|
    where they agree ("err")."""
    import torch
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.render import cbounce as cb
    na = shade_cfg[-1]
    stats = {}
    g_k = ops.bounce_shade_bwd(xt, *tabs, ct, *shade_cfg, stats=stats)
    g_k2 = ops.bounce_shade_bwd(xt, *tabs, ct, *shade_cfg)
    g_p = cb.cbody_vjp_reference(xt, *tabs, ct, *shade_cfg)
    need = cb.bwd_needs_body(xt, ct, tabs[2], na)
    dead = cb.dead_lanes(na, xt.shape[1], xt.device)
    dead_vjp = dead is None or torch.equal(g_k[0][:, dead], g_p[0][:, dead])
    dx, dxp = g_k[0][:, need], g_p[0][:, need]
    close = torch.isclose(dx, dxp, rtol=K4_RTOL, atol=K4_ATOL) \
        | (torch.isnan(dx) & torch.isnan(dxp))
    most, total, listed = stats["nodes"].tolist()
    return dict(
        dx_close=close.float().mean().item() if need.any() else 1.0,
        pass_through_exact=torch.equal(g_k[0][:, ~need],
                                       cb.bwd_pass_through(ct[:, ~need])),
        dead_lanes=0 if dead is None else int(dead.sum()),
        dead_vjp_exact=dead_vjp,
        table_rel=[((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                   for a, b in zip(g_k[1:], g_p[1:])],
        bit_identical=all(torch.equal(a, b) for a, b in zip(g_k, g_k2)),
        nodes_max=most, nodes_total=total, listed=listed,
        listed_plain=int(need.sum()),
        # lanes let through whose plain VJP is not finite (ROADMAP Queue 3)
        skip_nonfinite=int((~need & ~torch.isfinite(g_p[0]).all(0)).sum()),
        err=(dx - dxp).abs()[close].max().item() if need.any() else 0.0)


def k4_ok(r):
    """Whether a k4_compare row meets phase 7's gates."""
    from arendur_tpu_torch.kernels import ops
    return (r["dx_close"] >= K4_GATE and r["pass_through_exact"]
            and max(r["table_rel"]) <= TAB_GATE and r["bit_identical"]
            and r["nodes_max"] <= ops.TAPE_CAP
            and r["listed"] == r["listed_plain"] and r["dead_vjp_exact"])


def plain_backward_shade():
    """The bounce shade with the K3 forward and the backward of PR 1,
    autograd over the plain body: the plain-backward leg of phase 8."""
    import torch
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.render import cbounce as cb

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xt, ltab, mtab, stab, static, md, rr, n_alive):
            ctx.save_for_backward(xt, ltab, mtab, stab)
            ctx.cfg = (static, md, rr, n_alive)
            return ops.bounce_shade(xt, ltab, mtab, stab, static, md, rr,
                                    n_alive)

        @staticmethod
        def backward(ctx, g):
            grads = cb.cbody_vjp_reference(*ctx.saved_tensors, g, *ctx.cfg)
            return tuple(grads) + (None,) * 4

    def shade(xt, ltab, mtab, stab, static, md, rr, n_alive=None):
        return Fn.apply(xt, ltab, mtab, stab, static, md, rr, n_alive)
    return shade


def batched_products(prof):
    """The batched matrix products (aten::bmm / aten::baddbmm) a profile
    ran: the frame transforms of the earlier instanced route."""
    return sum(1 for e in prof.events()
               if e.name in ("aten::bmm", "aten::baddbmm"))


def wave_profile(fn):
    """A trace of one fn() that holds its device events, for _busy_s."""
    _, prof = profiled(fn)
    if prof is None:
        raise AssertionError("no profiler trace held the device events")
    return prof


def _busy_s(prof):
    """Device time of a profile: the union of its kernel intervals
    (a sum of key_averages() would count an op's kernels twice), their
    count, and the time of the port's own kernels by name."""
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.end > 0]
    own = {}
    for e in events:
        for k in ("bounce_shade_bwd", "bounce_shade_kernel",
                  "hit_shade_kernel", "shade_split_kernel",
                  "slot_sample_kernel", "slot_eval_pdf_kernel",
                  "slot_order", "cluster_kernel", "instanced_kernel"):
            if k in e.name:
                own[k] = own.get(k, 0.0) + 1e-6 * (e.time_range.end
                                                   - e.time_range.start)
                break
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6, len(spans), own


def _block_mean(a, f):
    h, w, _ = a.shape
    return a.reshape(h // f, f, w // f, f, 3).mean((1, 3))


def event_timed(fn):
    """(fn(), its ms by CUDA events around the one call; no warm-up: the
    walk's calls are long and the script has run the same ops before)."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def frame_rate(render, wave_s, n_frame, wave, limit_s=60.0):
    """Forward paths/s: a whole timed frame (render()) where wave 0's
    wall time wave_s says the frame takes at most limit_s, else wave 0's
    own rate.  (rate, whole)."""
    import torch
    if wave_s * n_frame / wave > limit_s:
        return wave / wave_s, False
    t0 = time.perf_counter()
    img = render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(img).all():
        raise AssertionError("a 256x256 render is not finite")
    return n_frame / dt, True


def grad_rel(g, g_plain):
    return ((g - g_plain).norm() / g_plain.norm().clamp(min=1e-30)).item()


def phase17(dev, card, ds, camera, film_cfg, config, wave0):
    """Phase 17: the BVH walk and the brute force, the Sobol sampler,
    checkpoint / resume, and the composed and texel gradients.  ds,
    camera, film_cfg, config: cb.json at 256x256, 16 spp, depth 8 (the
    cluster scene); wave0: (pxy, pid, sid) of its wave 0.  Returns the
    measurements; raises where a gate fails."""
    import tempfile
    import numpy as np
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch import utils
    from arendur_tpu_torch.accel import bvh as bvhmod
    from arendur_tpu_torch.filming import film as flm
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.parallel import mesh
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp
    from arendur_tpu_torch.sampling import sobol
    from arendur_tpu_torch.shapes import triangle as tri

    cb_json = os.path.join(REPO, "examples/cornellbox/cb.json")
    etex_json = os.path.join(REPO, "examples/cornellbox/cb_etex.json")
    pxy, pid, sid = wave0
    n = pxy.shape[0]
    n_frame = film_cfg.resolution[0] * film_cfg.resolution[1] * config.spp
    m = {}

    def parse(path, spp, res, intersector="cluster"):
        s, cam_, film_, cfg_, _ = scenedesc.parse_scene(
            path, spp_override=spp, resolution_override=res,
            intersector=intersector)
        return s, cam_, film_, dataclasses.replace(cfg_, max_depth=8,
                                                   wave_size=n)

    def one_wave(cfg_, film_):
        """cfg_ with one wave for the whole frame."""
        w_, h_ = film_.resolution
        return dataclasses.replace(cfg_, wave_size=w_ * h_ * cfg_.spp)

    def launched(fn, need, refuse=()):
        """fn() with every count set to 0 just before and read just
        after; every kernel in `need` must have launched, none in
        `refuse`."""
        ops.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        lau = ops.counts()
        if any(lau[k] < 1 for k in need) or any(lau[k] for k in refuse):
            raise AssertionError(f"phase 17 launches: {lau}")
        return out, lau

    # (a) the walk and the brute force on phase 3's recorded wave queries,
    # against K1 / K2 without the sphere table on the same rays.  A lane
    # agrees where the triangle (blocked) is the same and, on a hit, t is
    # within T_RTOL of max(t, 1): K1 takes t from plane products in the
    # scene's absolute coordinates (a few ulp of a coordinate near a
    # surface), the watertight test from the sheared ray.  K1 / K2 skip
    # hits closer than their self-hit guard, 1e-5 (1 + max |o|)
    # (shapes/mxu_intersect.py ray_teps); the watertight test of the JAX
    # package's walk has none that wide, so a lane whose other hit lies
    # inside that guard is counted apart ("guard")
    isecs = {k: sc.DeviceScene.build(parse(cb_json, config.spp,
                                           film_cfg.resolution, k)[0], dev)
             for k in ("bvh", "naive")}
    queries = fuzz.wave_queries(ds, camera, film_cfg, config,
                                integ.KERNEL_OPS)
    qrows, split, failed = [], [], []
    for qi, q in enumerate(queries):
        na = n if q["n_alive"] is None else int(q["n_alive"])
        o, d, tm = q["o"][:na], q["d"][:na], q["tmax"][:na]
        teps = 1e-5 * (1.0 + o.abs().amax(-1))
        closest = q["kind"] == "closest"
        row = dict(query=qi, kind=q["kind"], live=na)
        if closest:
            t_k, slot = ops.closest_hit(ds.cw, ds.cbox, o, d, tm)
            idx_k = torch.where(slot >= 0,
                                ds.remap[torch.clamp(slot, min=0).long()], -1)
        else:
            blk_k = ops.any_hit(ds.cw, ds.cbox, o, d, tm)
        for name, dsx in isecs.items():
            st = {}
            if closest and name == "bvh":
                call = lambda: bvhmod.intersect_bvh(  # noqa: E731
                    dsx.bvh, o, d, tm, stats=st)
            elif closest:
                call = lambda: tri.intersect_scene_tris(  # noqa: E731
                    o, d, tm, *dsx.tri_v)
            else:
                call = lambda: sc.world_occluded(dsx, o, d, tm)  # noqa
            out, row[name + "_ms"] = event_timed(call)
            if name == "bvh" and closest:
                row["bvh_steps"] = st["steps"]
            if closest:
                t_x, idx_x = out[0], out[1]
                rel = (t_x - t_k).abs() / t_k.abs().clamp(min=1.0)
                hit = idx_k >= 0
                eq = (idx_x == idx_k) & (~hit | (rel <= T_RTOL))
                both = (idx_x == idx_k) & hit
                row[name + "_t_rel_max"] = rel[both].max().item() \
                    if both.any() else 0.0
            else:
                eq = out == blk_k
                row[name + "_blocked"] = out.float().mean().item()
                # the other intersector's nearest hit on the split lanes
                t_x = torch.full_like(tm, float("inf"))
                bad = torch.nonzero(~eq)[:, 0]
                if bad.numel():
                    t_x[bad] = tri.intersect_scene_tris(
                        o[bad], d[bad], tm[bad], *isecs["naive"].tri_v)[0]
            guard = ~eq & (t_x <= teps)
            row[name + "_lanes_equal"] = eq.float().mean().item()
            row[name + "_guard"] = int(guard.sum())
            row[name + "_lanes_equal_past_guard"] = (
                eq | guard).float().mean().item()
            for lane in torch.nonzero(~eq)[:, 0].tolist():
                split.append((name, qi, lane, "guard" if guard[lane] else
                              "other") + ((int(idx_k[lane]), int(idx_x[lane]),
                                           float(t_k[lane]))
                                          if closest else
                                          (bool(blk_k[lane]),
                                           bool(out[lane])))
                             + (float(t_x[lane]),))
            if row[name + "_lanes_equal_past_guard"] < K1_K2_GATE:
                failed.append(row)
        qrows.append(row)
    m["queries"], m["query_splits"] = qrows, split
    closest = [r for r in qrows if r["kind"] == "closest"]
    anyq = [r for r in qrows if r["kind"] == "any"]
    _say("[17] lanes where the walk / the brute force and K1 / K2 disagree "
         "(intersector, query, lane, inside K1 / K2's self-hit guard or "
         "not, K1 triangle, its triangle, K1 t, its t; any hit: K2 blocked, "
         "its blocked, its nearest t): "
         + ("; ".join(str(s) for s in split) or "none"))
    mean = lambda rows, k: sum(r[k] for r in rows) / len(rows)  # noqa
    _say("[17] the BVH walk and the brute force on phase 3's wave queries "
         f"({len(closest)} closest, {len(anyq)} any; world triangles, K1 / "
         "K2 without the sphere table): " + "; ".join(
             f"{nm}: min lanes equal {min(r[nm + '_lanes_equal'] for r in qrows):.6f} "
             f"({sum(r[nm + '_guard'] for r in qrows)} lanes inside the "
             f"guard; past it {min(r[nm + '_lanes_equal_past_guard'] for r in qrows):.6f}), "
             f"closest {mean(closest, nm + '_ms'):.2f} ms / any "
             f"{mean(anyq, nm + '_ms'):.2f} ms a query (events)"
             for nm in ("bvh", "naive"))
         + "; BVH steps per closest query "
         + ", ".join(str(r["bvh_steps"]) for r in closest)
         + "; per query live / bvh ms / naive ms: " + ", ".join(
             f"{r['live']}/{r['bvh_ms']:.2f}/{r['naive_ms']:.2f}"
             for r in qrows) + f" ({card})")
    if failed:
        raise AssertionError(f"bvh / naive queries below {K1_K2_GATE}: "
                             f"{failed}")
    mean = lambda rows, k: sum(r[k] for r in rows) / len(rows)  # noqa

    # (b) the bvh and naive renders at 64x48, 32 spp, depth 8 through the
    # kernels (K1 / K2 with no cluster, K8, K9) against the cluster render
    # and each other, naive's against the plain path (bvh runs the same
    # kernels); their launches and wall time a 65,536-lane wave; the
    # forward rate at 256x256, 16 spp, depth 8
    s5, cam5, film5, cfg5 = parse(cb_json, 32, (64, 48))
    cfg5 = one_wave(cfg5, film5)
    ds5 = sc.DeviceScene.build(s5, dev)
    img_c = integ.render(ds5, cam5, film5, cfg5)
    comp_need = ("closest_hit_spheres", "any_hit_spheres", "slot_sample",
                 "slot_eval_pdf")
    shades = ("bounce_shade", "hit_shade", "shade_split")
    imgs = {}
    for name in ("bvh", "naive"):
        sx = parse(cb_json, 32, (64, 48), name)[0]
        dsx = sc.DeviceScene.build(sx, dev)
        img, lau = launched(lambda: integ.render(dsx, cam5, film5, cfg5),
                            comp_need, shades)
        imgs[name] = img
        if name == "naive":
            img_p = integ.render(dsx, cam5, film5, cfg5, ops=integ.PLAIN_OPS)
        dpix = (img - img_c).abs().amax(-1)
        dfull = isecs[name]
        wave_args = (dfull, camera, config, pxy, pid, sid,
                     smp.make_base_key(0))
        with torch.no_grad():
            t0 = time.perf_counter()
            _, wave_lau = launched(lambda: integ.trace_wave(*wave_args),
                                   comp_need, shades)
            wave_s = time.perf_counter() - t0
        rate, whole_f = frame_rate(
            lambda: integ.render(dfull, camera, film_cfg, config), wave_s,
            n_frame, n)
        m[name] = dict(render_launches=lau,
                       dmax=dpix.max().item(),
                       pixels_past=int((dpix > PLAIN_ATOL).sum()),
                       dmean=(img.mean() - img_c.mean()).abs().item(),
                       wave_launches=wave_lau, paths_per_s=rate,
                       wave_s=wave_s, whole_frame=whole_f)
        if not torch.isfinite(img).all():
            raise AssertionError(f"{name} render is not finite")
    m["naive"]["dplain"] = (imgs["naive"] - img_p).abs().max().item()
    m["bvh"]["dnaive"] = (imgs["bvh"] - imgs["naive"]).abs().max().item()
    _say("[17] renders 64x48 32spp depth 8 through the kernels: " + "; ".join(
        f"{nm} launches {m[nm]['render_launches']}; against the cluster "
        f"render max |diff| {m[nm]['dmax']:.3e}, {m[nm]['pixels_past']} of "
        f"{64 * 48} pixels past {PLAIN_ATOL}, |mean diff| "
        f"{m[nm]['dmean']:.3e} (gate {MEAN_ATOL})" for nm in ("bvh", "naive"))
        + f"; naive max |kernel - plain| {m['naive']['dplain']:.3e} (gate "
        f"{PLAIN_ATOL}); bvh vs naive max |diff| {m['bvh']['dnaive']:.3e}"
        + " | 256x256 16spp depth 8 forward: " + "; ".join(
            f"{nm} {m[nm]['paths_per_s']:.0f} paths/s ("
            + ("whole frame" if m[nm]["whole_frame"] else
               f"wave 0 alone: the frame would take "
               f"{m[nm]['wave_s'] * n_frame / n:.0f} s")
            + f"; wave 0 {m[nm]['wave_s']:.3f} s), launches a wave "
            + str({k: m[nm]["wave_launches"][k] for k in comp_need})
            for nm in ("bvh", "naive")) + f" ({card})")
    if m["naive"]["dplain"] > PLAIN_ATOL or m["bvh"]["dnaive"] > PLAIN_ATOL \
            or max(m[nm]["dmean"] for nm in ("bvh", "naive")) > MEAN_ATOL:
        raise AssertionError(f"bvh / naive renders: {m}")

    # (c) Sobol: the 64x48, 32 spp render through the kernels against
    # the plain path, and its rate at 256x256, 16 spp, depth 8
    cfg_s = dataclasses.replace(cfg5, sampler="sobol",
                                sobol_table=sobol.build_sobol_table(
                                    cfg5.spp, 80))
    img_sk, lau_s = launched(lambda: integ.render(ds5, cam5, film5, cfg_s),
                             FORWARD_KERNELS)
    img_sp = integ.render(ds5, cam5, film5, cfg_s, ops=integ.PLAIN_OPS)
    ds_sobol = (img_sk - img_sp).abs().max().item()
    d_strata = (img_sk.mean() - img_c.mean()).abs().item()
    cfg_s16 = dataclasses.replace(config, sampler="sobol",
                                  sobol_table=sobol.build_sobol_table(
                                      config.spp, 80))
    with torch.no_grad():
        for _ in range(2):     # a warm wave, then the timed one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            integ.trace_wave(ds, camera, cfg_s16, pxy, pid, sid,
                             smp.make_base_key(0))
            torch.cuda.synchronize()
            wave_s_s = time.perf_counter() - t0
    rate_s, whole_s = frame_rate(
        lambda: integ.render(ds, camera, film_cfg, cfg_s16), wave_s_s,
        n_frame, n)
    m["sobol"] = dict(launches=lau_s, dplain=ds_sobol, dmean_strata=d_strata,
                      paths_per_s=rate_s, wave_s=wave_s_s,
                      whole_frame=whole_s)
    _say(f"[17] Sobol (table {cfg5.spp}x80) 64x48 32spp depth 8: launches "
         f"{lau_s}; max |kernel - plain| {ds_sobol:.3e} (gate {PLAIN_ATOL}); "
         f"|mean - the stratified render's mean| {d_strata:.3e} | 256x256 "
         f"16spp depth 8: {rate_s:.0f} paths/s ("
         + ("whole frame" if whole_s else "wave 0 alone")
         + f"; wave 0 {wave_s_s:.3f} s) ({card})")
    if not torch.isfinite(img_sk).all() or ds_sobol > PLAIN_ATOL \
            or d_strata > MEAN_GATE:
        raise AssertionError(f"Sobol render: {m['sobol']}")

    # (d) resume: 4 waves, cut after 2, resumed from the checkpoint
    cfg_r = dataclasses.replace(cfg5, wave_size=cfg5.wave_size // 4)
    ref = integ.render(ds5, cam5, film5, cfg_r)
    state, wave_r, n_waves = integ.render_film_init(ds5, film5, cfg_r)
    for i in range(2):
        integ.render_wave(ds5, cam5, film5, cfg_r, state, i)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "resume.ckpt.npz")
        utils.save_checkpoint(ckpt, state, 2 * wave_r, cfg_r.seed,
                              meta={"wave": wave_r})
        resumed = integ.render(ds5, cam5, film5, cfg_r, checkpoint_path=ckpt,
                               checkpoint_every=1)
        next_ray = utils.load_checkpoint(ckpt)[1]
    dres = (resumed - ref).abs().max().item()
    m["resume"] = dict(bit_identical=bool(torch.equal(resumed, ref)),
                       max_diff=dres, waves=n_waves, next_ray=next_ray)
    _say(f"[17] resume: a 64x48 32spp render of {n_waves} waves cut after 2 "
         f"and resumed from its checkpoint: bit-identical "
         f"{m['resume']['bit_identical']}, max |diff| {dres:.3e} (gate 1e-6)"
         f", final cursor {next_ray}")
    if dres > 1e-6 or next_ray != n_waves * wave_r:
        raise AssertionError(f"resume: {m['resume']}")

    # (e) the composed train step on cb_etex.json, 64x48, 32 spp, depth 8,
    # kernels against plain; fwd+bwd paths/s at 256x256 (one wave after a
    # warm step)
    s12, cam12, film12, cfg12 = parse(etex_json, 32, (64, 48))
    cfg12 = one_wave(cfg12, film12)
    ds12 = sc.DeviceScene.build(s12, dev)
    target = integ.render(ds12, cam12, film12, cfg12).reshape(-1, 3) * 0.8
    p12 = {k: torch.tensor(getattr(s12.materials, k), device=dev)
           for k in ("kd", "ks", "roughness")}
    idx12 = torch.arange(cfg12.wave_size, device=dev)
    grads, losses = {}, {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        step = mesh.train_step_fn(ds12, cam12, film12, cfg12, lr=GRAD_LR,
                                  ops=wops)
        (new, loss), lau = launched(
            lambda: step(dict(p12), target, idx12),
            COMPOSED_KERNELS if name == "kernels" else (),
            shades + ("bounce_shade_bwd",))
        if name == "kernels":
            comp_lau = lau
        grads[name] = {k: (p12[k] - new[k]) / GRAD_LR for k in new}
        losses[name] = loss.item()
    grel = {k: grad_rel(grads["kernels"][k], grads["plain"][k])
            for k in p12}
    finite = all(torch.isfinite(g).all().item()
                 for gs in grads.values() for g in gs.values())
    s_e, _, _, cfg_e = parse(etex_json, config.spp, film_cfg.resolution)
    ds_e = sc.DeviceScene.build(s_e, dev)
    config_e = dataclasses.replace(config, textures=cfg_e.textures)
    step = mesh.train_step_fn(ds_e, camera, film_cfg, config_e)
    kd0 = torch.tensor(s_e.materials.kd, device=dev) * 1.25
    tgt = torch.full((n_frame // config.spp, 3), 0.2, device=dev)
    idx0 = torch.arange(n, device=dev)
    kd, _ = step(kd0, tgt, idx0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(kd, tgt, idx0 + n)
    torch.cuda.synchronize()
    comp_fb = n / (time.perf_counter() - t0)
    m["composed_train"] = dict(launches=comp_lau, grad_rel=grel,
                               losses=losses, finite=finite,
                               fwd_bwd_paths_per_s=comp_fb)
    _say("[17] composed train step (cb_etex.json 64x48 32spp depth 8, kd / "
         f"ks / roughness): launches {comp_lau}; grad rel "
         + ", ".join(f"{k} {v:.2e}" for k, v in grel.items())
         + f" (gate {GRAD_GATE}), finite {finite}; loss kernels "
         f"{losses['kernels']:.6e} plain {losses['plain']:.6e} | fwd+bwd "
         f"256x256 16spp depth 8, one wave of {n}: {comp_fb:.0f} paths/s "
         f"({card})")
    if not finite or max(grel.values()) > GRAD_GATE:
        raise AssertionError(f"composed train step: {m['composed_train']}")

    # (f) the texel gradient on bench.py's checker scene, 64x48, 32 spp,
    # depth 8: the textured split (K1, K2, K5, the lookups, K6) kernels
    # against plain
    s_t, atlas = fuzz.checker_textured(s5, dev)
    ds_t = sc.DeviceScene.build(s_t, dev)
    w_ = film5.resolution[0]
    ridx = torch.arange(cfg5.wave_size, device=dev)
    pid_t, sid_t = ridx // cfg5.spp, ridx % cfg5.spp
    pxy_t = torch.stack([(pid_t % w_).float(), (pid_t // w_).float()], -1)
    tgrads = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        leaf = atlas.texels.clone().requires_grad_(True)
        cfg_t = dataclasses.replace(
            cfg5, textures=dataclasses.replace(atlas, texels=leaf))

        def texel_grad():
            pfilm, L = integ.trace_wave(ds_t, cam5, cfg_t, pxy_t, pid_t,
                                        sid_t, smp.make_base_key(0),
                                        ops=wops)
            st_ = flm.film_splat(film5, flm.film_init(film5, dev), pfilm, L)
            loss = (flm.film_finalize(st_, film5) ** 2).mean()
            return torch.autograd.grad(loss, [leaf])[0]
        tgrads[name], lau = launched(
            texel_grad, TEXTURED_KERNELS if name == "kernels" else (),
            ("bounce_shade",))
        if name == "kernels":
            tex_lau = lau
    trel = grad_rel(tgrads["kernels"], tgrads["plain"])
    tfinite = all(torch.isfinite(g).all().item() for g in tgrads.values())
    m["texel_grad"] = dict(launches=tex_lau, grad_rel=trel, finite=tfinite,
                           nonzero=int((tgrads["kernels"] != 0).sum()))
    _say("[17] texel gradient (bench.py's checker on cb.json, 64x48 32spp "
         f"depth 8, mean squared image): launches {tex_lau}; grad rel "
         f"{trel:.2e} (gate {GRAD_GATE}), finite {tfinite}, "
         f"{m['texel_grad']['nonzero']} of {tgrads['kernels'].numel()} "
         f"entries nonzero ({card})")
    if not tfinite or trel > GRAD_GATE or not m["texel_grad"]["nonzero"]:
        raise AssertionError(f"texel gradient: {m['texel_grad']}")
    return m


@contextlib.contextmanager
def plain_sweeps():
    """While the block runs, the slot-sweep dispatchers of
    bxdf/slot_shade.py are their plain versions (bxdf/slots.py), so
    slots.bsdf_evaluate / bsdf_pdf / rho_hd / rho_hh run K8 / K9's plain
    versions on CUDA tensors."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    saved = ssh.bsdf_sample, ssh.bsdf_eval_pdf
    ssh.bsdf_sample, ssh.bsdf_eval_pdf = sl.bsdf_sample, sl.bsdf_eval_pdf
    try:
        yield
    finally:
        ssh.bsdf_sample, ssh.bsdf_eval_pdf = saved


def slot_entry_times(b, wo, x, types, sample, iters=10):
    """ms by CUDA events per call, inputs rotated past the L2, of K8
    (sample) or K9 on one BSDF: the sweep as the entry launches it (K8
    in the BSDF's recipe order, K9 in wave order), K8's order alone (two
    launches), the earlier route's raw launch on the lane-major pack (in
    wave order), and the whole entry calls, BSDF in and outputs out: the
    new route on a BSDF seen first (its fields checked, K8's order
    built) and on one whose checks and order are kept, and the earlier
    route (pack, launch, split)."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.kernels import ops
    packed = ops.slot_sample_packed if sample else ops.slot_eval_pdf_packed
    entry = ssh.bsdf_sample if sample else ssh.bsdf_eval_pdf
    earlier = ssh.sample_packed if sample else ssh.eval_pdf_packed
    copies = slot_rotation(b, wo, x)
    t = lambda fn: time_ms(cycling(fn, copies), iters)  # noqa: E731
    if sample:
        out = dict(
            sweep=t(lambda bb, w, x_: ops.slot_sample(
                bb, w, x_, types, ssh.lane_order(bb))),
            order=t(lambda bb, w, x_: ops.slot_order(bb)))
    else:
        out = dict(sweep=t(lambda bb, w, x_: ops.slot_eval_pdf(
            bb, w, x_, types)))
    out.update(
        entry_first=t(lambda bb, w, x_: entry(bb.replace(), w, x_, types)),
        entry_kept=t(lambda bb, w, x_: entry(bb, w, x_, types)),
        earlier_entry=t(lambda bb, w, x_: earlier(bb, w, x_, types)))
    del copies
    xs = ssh.pack_slots(b, wo, x)
    out["earlier_raw"] = time_ms(rotating(
        lambda x_: packed(x_, types, b.present, b.dists), xs), iters)
    return out


def slot_wave_ms(prof):
    """K8's, K9's and the recipe order's device ms and launches in a
    profile of one wave."""
    got = {}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.time_range.end <= 0:
            continue
        k = ("K8" if "slot_sample_kernel" in e.name else
             "K9" if "slot_eval_pdf_kernel" in e.name else
             "order" if "slot_order" in e.name else None)
        if k:
            c, t_ = got.get(k, (0, 0.0))
            got[k] = (c + 1, t_ + 1e-3 * (e.time_range.end
                                          - e.time_range.start))
    return got


def step_rel(p, a, b):
    """Two train steps' (new_params, loss) from the parameters p: the
    relative differences of their gradients (read back with GRAD_LR) and
    losses."""
    rel = {k: grad_rel((p[k] - a[0][k]) / GRAD_LR, (p[k] - b[0][k]) / GRAD_LR)
           for k in p}
    rel["loss"] = abs(a[1].item() - b[1].item()) / abs(b[1].item())
    return rel


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms for the block (a warning where
    an op has none): index_add_ then sums in sorted order on the card."""
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def timed(fn):
    """(fn(), its wall seconds, the card synchronised on both sides)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase18(dev, card, ds, camera, film_cfg, config):
    """Phase 18: the sharded render and train step (parallel/mesh.py) in
    a one-rank NCCL group against the one-device paths, two worker
    processes on the one card over gloo (parallel/distributed.py,
    render_multihost) against each other and the one-process render,
    and the leftover API's K8 / K9 calls (slots.rho_hd / rho_hh,
    bsdf_evaluate / bsdf_pdf) against their plain versions.  ds, camera,
    film_cfg, config: cb.json at 256x256, 16 spp, depth 8, waves of
    65,536.  Returns the measurements; raises where a gate fails."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from arendur_tpu_torch.bxdf import slots as sl
    from arendur_tpu_torch.filming import film as flm
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.parallel import distributed as pdist
    from arendur_tpu_torch.parallel import mesh
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ

    w, h = film_cfg.resolution
    n_frame = w * h * config.spp
    wave = config.wave_size
    m = {}

    def launched(fn, need):
        """fn() with every count set to 0 just before and read just
        after; every kernel in `need` must have launched."""
        ops.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        lau = ops.counts()
        if any(lau[k] < 1 for k in need):
            raise AssertionError(f"phase 18 launches: {lau}")
        return out, lau

    one = lambda: integ.render(ds, camera, film_cfg, config)  # noqa: E731
    img1, t1 = timed(one)

    # (a) one rank over NCCL: the sharded render and train step against
    # the one-device render and train_step_fn on the same wave
    with tempfile.TemporaryDirectory() as tmp:
        rm = pdist.init_distributed(
            num_processes=1, process_id=0, device=dev, timeout_s=300,
            init_method="file://" + os.path.join(tmp, "rendezvous"))
        try:
            if dist.get_backend() != "nccl" or rm.size != 1:
                raise AssertionError(f"not a one-rank NCCL group: "
                                     f"{dist.get_backend()} {rm}")
            run = lambda: mesh.render_sharded(  # noqa: E731
                ds, camera, film_cfg, config, rm)
            run()
            # timed in turns with the one-process render: one, sharded,
            # sharded, one
            (img_r, t_r), lau_r = launched(lambda: timed(run),
                                           FORWARD_KERNELS)
            t_r2 = timed(run)[1]
            t1b = timed(one)[1]
            d_r = (img_r - img1).abs().max().item()
            if not torch.isclose(img_r, img1, rtol=1e-4, atol=1e-5).all():
                raise AssertionError(f"one-rank NCCL render differs from "
                                     f"the one-device render: {d_r}")
            st = flm.film_init(film_cfg, dev, padded=True)
            ar_ms = time_ms(lambda: (rm.all_reduce_(st.rgb),
                                     rm.all_reduce_(st.weight)), iters=20)
            p = {k: torch.tensor(getattr(ds.materials, k), device=dev)
                 for k in ("kd", "ks", "roughness")}
            target = img1.reshape(-1, 3) * 0.8
            idx = torch.arange(wave, device=dev)
            step_r = mesh.sharded_train_step_fn(ds, camera, film_cfg, config,
                                                rm, lr=GRAD_LR)
            step_1 = mesh.train_step_fn(ds, camera, film_cfg, config,
                                        lr=GRAD_LR)
            call_r = lambda: step_r(dict(p), target, idx)  # noqa: E731
            call_1 = lambda: step_1(dict(p), target, idx)  # noqa: E731
            call_r(), call_1()
            ((new_r, loss_r), ts_r), lau_t = launched(
                lambda: timed(call_r), TRAIN_KERNELS)
            (new_1, loss_1), ts_1 = timed(call_1)
            # the one-device step against itself: the scatter splat's
            # index_add_ sums a pixel's taps with atomics, in another
            # order each run; with PyTorch's deterministic algorithms it
            # sums them sorted, and the two steps are held against each
            # other there
            spread = step_rel(p, call_1(), (new_1, loss_1))
            with deterministic_algorithms():
                rel = step_rel(p, call_r(), call_1())
        finally:
            dist.destroy_process_group()
    rate1 = [n_frame / t1, n_frame / t1b]
    rate_r = [n_frame / t_r, n_frame / t_r2]
    m.update(one_process_paths_per_s=rate1, nccl_paths_per_s=rate_r,
             nccl_dmax=d_r,
             nccl_launches=lau_r, nccl_all_reduce_ms=ar_ms,
             nccl_step_rel=rel, nccl_step_spread=spread,
             nccl_step_launches=lau_t,
             nccl_step_s=ts_r, one_device_step_s=ts_1)
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    _say(f"[18] one rank over NCCL, cb.json {w}x{h} {config.spp}spp depth "
         f"{config.max_depth}, waves of {wave}: in turns, one-process render "
         f"{rate1[0]:.0f}, render_sharded {rate_r[0]:.0f} / {rate_r[1]:.0f},"
         f" one-process {rate1[1]:.0f} paths/s; max |sharded - one-device| "
         f"{d_r:.3e}"
         f" (gate rtol 1e-4 / atol 1e-5), launches {nz(lau_r)}; the film's "
         f"all-reduce (rgb and weight) {ar_ms:.4f} ms a frame | "
         f"sharded_train_step_fn on wave 0 (kd, ks, roughness, lr "
         f"{GRAD_LR:g}) against train_step_fn under deterministic "
         "algorithms: rel "
         + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
         + " (gate 1e-5); train_step_fn against itself (atomic splat): "
         + ", ".join(f"{k} {v:.2e}" for k, v in spread.items())
         + f"; {1e3 * ts_r:.1f} / {1e3 * ts_1:.1f} ms a step, launches "
         f"{nz(lau_t)} ({card})")
    if max(rel.values()) > 1e-5:
        raise AssertionError(f"one-rank NCCL step differs: {rel}")

    # (b) two worker processes on the one card over gloo (gloo stages the
    # film through the host), each rendering half of every wave, in turns
    # with rank 0 rendering the whole frame alone; then one
    # sharded_train_step_fn step on wave 0 with two ranks, held against
    # train_step_fn under deterministic algorithms
    rounds = 4
    scene_args = ["--scene", os.path.join(REPO, "examples/cornellbox/cb.json"),
                  "--res", f"{w}x{h}", "--spp", str(config.spp), "--depth",
                  str(config.max_depth), "--wave", str(wave)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        imgs, reps, rcs = pdist.spawn_workers(
            2, tmp, device=str(dev), backend="gloo", scene_args=scene_args,
            runs=rounds, timeout_s=300, train_lr=GRAD_LR)
        spawn_s = time.perf_counter() - t0
    if any(rcs):
        raise AssertionError(f"a gloo worker failed: {rcs}")
    steps = [r.pop("step") for r in reps]
    d_ranks = float(np.abs(imgs[1] - imgs[0]).max())
    ref = img1.cpu().numpy()
    d_one = float(np.abs(imgs[0] - ref).max())
    rate2 = [n_frame / max(r["seconds"][k] for r in reps)
             for k in range(rounds)]
    alone = reps[0]["alone_paths_per_s"]
    gloo_ar = [1e3 * r["phases"]["film all-reduce"] for r in reps]
    target = torch.tensor(imgs[0], device=dev).reshape(-1, 3) * 0.8
    with deterministic_algorithms():
        one_step = mesh.train_step_fn(ds, camera, film_cfg, config,
                                      lr=GRAD_LR)(dict(p), target, idx)
    two = [({k: torch.tensor(st[k], device=dev) for k in p},
            torch.tensor(float(st["loss"]))) for st in steps]
    rel2 = step_rel(p, two[0], one_step)
    d_step = max(float(np.abs(steps[1][k] - steps[0][k]).max())
                 for k in steps[0])
    m.update(gloo_paths_per_s=rate2, gloo_alone_paths_per_s=alone,
             gloo_reports=reps, gloo_dranks=d_ranks, gloo_dmax=d_one,
             gloo_spawn_s=spawn_s, gloo_all_reduce_ms=gloo_ar,
             gloo_step_rel=rel2, gloo_step_dranks=d_step)
    _say(f"[18] two processes on {dev} over gloo (render_multihost; "
         f"after a warm-up round, {rounds} rounds, each a render by the two "
         "ranks and one by rank 0 alone, in turns, with no synchronisation "
         "inside them): "
         + ", ".join(f"{a:.0f}" for a in rate2) + " paths/s for the frame "
         "by the two, " + ", ".join(f"{a:.0f}" for a in alone)
         + " by rank 0 alone; the film's all-reduce through the host (a "
         "synchronised render) " + ", ".join(f"{a:.3f}" for a in gloo_ar)
         + " ms a frame; launches per rank "
         + "; ".join(str(nz(r["launches"])) for r in reps)
         + f"; |rank 1 - rank 0| {d_ranks:.3e} (gate 1e-7), max |two-process"
         f" - one-process| {d_one:.3e} (gate rtol 1e-4 / atol 1e-5) | "
         "sharded_train_step_fn with two ranks on wave 0 against "
         "train_step_fn under deterministic algorithms: rel "
         + ", ".join(f"{k} {v:.2e}" for k, v in rel2.items())
         + f" (gate 1e-5), |rank 1 - rank 0| {d_step:.3e} (gate 1e-7), "
         "launches per rank "
         + "; ".join(str(nz(r["step_launches"])) for r in reps)
         + f"; workers {spawn_s:.1f} s from spawn to exit ({card})")
    if d_ranks > 1e-7:
        raise AssertionError(f"the gloo ranks' images differ: {d_ranks}")
    if not np.allclose(imgs[0], ref, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"two-process render differs: {d_one}")
    if any(min(r["launches"][k] for k in FORWARD_KERNELS) < 1 for r in reps):
        raise AssertionError("a gloo worker launched no kernel")
    if any(min(r["step_launches"][k] for k in TRAIN_KERNELS) < 1
           for r in reps):
        raise AssertionError("a gloo worker's step launched no kernel")
    if max(rel2.values()) > 1e-5 or d_step > 1e-7:
        raise AssertionError(f"two-rank step differs: {rel2}, {d_step}")

    # (c) the leftover API on the card: rho_hd / rho_hh (K8, one launch a
    # sample) and bsdf_evaluate / bsdf_pdf (K9, one launch each) against
    # the same functions over the plain sweeps, on 65,536 fuzz lanes (the
    # five recipes; grazing glass), equal to the bit
    n = 1 << 16
    rng = np.random.default_rng(18)
    cases = {"recipes": dict(), "grazing": dict(grazing=True,
                                                rows=fuzz.SLOT_ROWS[3:4])}
    left = {}
    for case, kw in cases.items():
        b, wo, _, wi = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(n, 18, **kw),
                                       dev)
        s, s1, s2 = (torch.tensor(rng.random((4, n, 2)).astype(np.float32),
                                  device=dev) for _ in range(3))

        def run():
            return (sl.rho_hd(b, wo, s), sl.rho_hh(b, s1, s2)) \
                + sl.bsdf_evaluate(b, wo, wi) + (sl.bsdf_pdf(b, wo, wi),)
        got, lau = launched(run, ("slot_sample", "slot_eval_pdf"))
        if (lau["slot_sample"], lau["slot_eval_pdf"]) != (8, 2):
            raise AssertionError(f"leftover launches: {lau}")
        with plain_sweeps():
            ref_, lau_p = launched(run, ())
        if lau_p["slot_sample"] or lau_p["slot_eval_pdf"]:
            raise AssertionError(f"the plain sweeps launched: {lau_p}")
        left[case] = {k: bit_diff(g, r_) for k, g, r_ in zip(
            ("rho_hd", "rho_hh", "f", "kinds", "pdf"), got, ref_)}
    m["leftovers"] = left
    _say("[18] the leftover API on 65,536 fuzz lanes, K8 (rho_hd / rho_hh, "
         "4 samples each) and K9 (bsdf_evaluate, bsdf_pdf) against the plain "
         "sweeps, elements that differ: " + "; ".join(
             f"{c} " + ", ".join(f"{k} {v}" for k, v in d.items())
             for c, d in left.items()) + f" ({card})")
    if any(v for d in left.values() for v in d.values()):
        raise AssertionError(f"leftover K8 / K9 differ: {left}")
    return m


def phase19(dev, card, big_tables, scratch):
    """Phase 19: scenes past the shared memory the kernels once staged
    whole (tools/make_cb_big_tables.py): cb.json with 2,500 small sphere
    lights over 48 new materials (ltab [2502, 53], mtab [57, 16], ktab
    [2502, 24]), the same spheres unlit, and cb_inst's box on a 17 x 17
    grid (289 instances, 578 sphere lights).  Returns the measurements;
    raises where a gate fails."""
    import numpy as np
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.filming import camera as cam
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.lighting import nee
    from arendur_tpu_torch.parallel import mesh
    from arendur_tpu_torch.render import bpt, whitted
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    from arendur_tpu_torch.shapes import sphere as sph

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """The seconds since the last lap, kept under `name`."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    n = 1 << 16
    paths = {name: big_tables.write(os.path.join(scratch, name + ".json"),
                                    desc)
             for name, desc in (("lights", big_tables.lights_desc()),
                                ("unlit", big_tables.lights_desc(lights=0)),
                                ("grid", big_tables.grid_desc(17)))}

    def parse(name, spp, res, depth, wave=None):
        scene, camera, film, config, _ = scenedesc.parse_scene(
            paths[name], spp_override=spp, resolution_override=res)
        config = dataclasses.replace(
            config, max_depth=depth,
            wave_size=wave or res[0] * res[1] * spp)
        return scene, sc.DeviceScene.build(scene, dev), camera, film, config

    # the 256x256, 16 spp, depth-8 waves (cb.json's camera, film and
    # settings) of the lights scene and of cb.json itself
    s_b, ds_b, cam_b, film_b, cfg_b = parse("lights", 16, (256, 256), 8, n)
    s_c = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"))[0]
    ds_c = sc.DeviceScene.build(s_c, dev)
    shade_cfg = (cfg_b.min_depth, cfg_b.rr_threshold)

    # the staging plans: past every shade kernel's cap a table stays in
    # place, the block's shared memory within a block's, the C entries'
    # bytes equal to the plan's; K1 / K2's block, one size for any table,
    # fits an SM
    nl, cl = ds_b.ltab.shape
    nm, ns = ds_b.mtab.shape[0], ds_b.stab.shape[0]
    plans = {k: ops.stage_plan(k, nl, cl, nm, ns)
             for k in ("K3", "K4", "K5", "K6")}
    whole = {"K3": ops.STAGE_ALL, "K4": ops.STAGE_ALL, "K5": ops.STAGE_S,
             "K6": ops.STAGE_L}
    occ = {"K3": ops.shade_occupancy(ds_b.ltab, ds_b.mtab, ds_b.stab),
           "K6": ops.shade_occupancy(ds_b.ltab)}
    occ["K1"] = dict(zip(("smem", "blocks_per_sm"),
                         ops.isect_occupancy(False)))
    occ["K2"] = dict(zip(("smem", "blocks_per_sm"),
                         ops.isect_occupancy(True)))
    if any(plans[k].staged == whole[k] or plans[k].smem > ops.SMEM_LIMIT
           for k in plans) or any(occ[k]["smem"] != plans[k].smem
                                  for k in ("K3", "K6")) \
            or min(v["blocks_per_sm"] for v in occ.values()) < 1:
        raise AssertionError(f"phase 19 plans: {plans}, {occ}")
    lap("scenes and plans")

    # K1 / K2 at 65,536 rays with a live count against the plain versions
    v = np.concatenate([s_b.tri_v0, s_b.tri_v1, s_b.tri_v2])
    o, d, tm = (torch.tensor(a, device=dev) for a in fuzz.sphere_rays(
        s_b.spheres, v.min(0), v.max(0), n, 19))
    na = torch.tensor(n - 9000, device=dev)
    live = torch.arange(n, device=dev) < n - 9000
    args = (ds_b.cw, ds_b.cbox, o, d, tm, na)
    kw = dict(sph_tab=ds_b.ktab, full_phi=ds_b.full_phi)
    t_k, s_k = ci.intersect_clusters(*args, **kw)
    t_p, s_p = ci.intersect_clusters_reference(*args, **kw)
    b_k = ci.occluded_clusters(*args, **kw)
    b_p = ci.occluded_clusters_reference(*args, **kw)
    fr, split, tie, k12_err, t_eq = sphere_agreement(t_k, s_k, t_p, s_p,
                                                     live)
    k12 = dict(codes_agree=fr, sphere_splits=split, sphere_ties=tie,
               sphere_t_equal=t_eq,
               blocked_agree=((b_k == b_p) & live).sum().item()
               / (n - 9000),
               dead_lanes_miss=bool((s_k[~live] == -1).all()
                                    and not b_k[~live].any()),
               sphere_lanes=int(((s_k <= -2) & live).sum()),
               blocked=b_k[live].float().mean().item())
    if split > tie or not t_eq or not k12["dead_lanes_miss"] \
            or fr < K1_K2_GATE or k12["blocked_agree"] < K1_K2_GATE:
        raise AssertionError(f"K1 / K2 past the cap: {k12}")
    lap("K1 / K2")

    def recorded_wave(dsx, scene_x, textured):
        """Wave 0 through the kernels: its K3 calls, or its K5 and K6
        calls on the scene with bench.py's checker kd, and the launches
        of the wave."""
        hits = []

        def rec_hit(xt, stab):
            out = cb.hit_shade_t(xt, stab)
            hits.append(dict(xt=xt.detach().clone(), out=out.clone()))
            return out
        cfg_x = cfg_b
        if textured:
            scene_t, atlas = fuzz.checker_textured(scene_x, dev)
            dsx = sc.DeviceScene.build(scene_t, dev)
            cfg_x = dataclasses.replace(cfg_b, textures=atlas)
        ops.reset_counts()
        shades = fuzz.wave_shades(dsx, cam_b, film_b, cfg_x,
                                  dataclasses.replace(integ.KERNEL_OPS,
                                                      hit_shade=rec_hit))
        torch.cuda.synchronize()
        return dsx, shades, hits, ops.counts()

    # K3, K5 and K6 equal to their plain versions to the bit on every lane
    # (and to the wave's own launch): the first bounce and bounce 3 of
    # wave 0 (compacted, with its live count)
    waves = {}
    for nm_, scene_x, dsx in (("lights", s_b, ds_b), ("cb.json", s_c, ds_c)):
        waves[nm_] = dict(fused=recorded_wave(dsx, scene_x, False),
                          textured=recorded_wave(dsx, scene_x, True))
    fused_b, tex_b = waves["lights"]["fused"], waves["lights"]["textured"]
    if not fused_b[3]["bounce_shade"] or min(
            tex_b[3][k] for k in ("hit_shade", "shade_split")) < 1:
        raise AssertionError(f"phase 19 waves' launches: {fused_b[3]}, "
                             f"{tex_b[3]}")
    eq = []
    for b in (0, 3):
        r = fused_b[1][b]
        tabs = (ds_b.ltab, ds_b.mtab, ds_b.stab, ds_b.static) + shade_cfg
        o_k = cb.bounce_shade_t(r["xt"], *tabs, n_alive=r["n_alive"])
        o_p = cb.cbody_reference(r["xt"], *tabs, n_alive=r["n_alive"])
        eq.append(("K3", b, bit_diff(o_k, o_p), bit_diff(o_k, r["out"])))
        r = tex_b[1][b]
        args6 = (tex_b[0].ltab, tex_b[0].static) + shade_cfg
        o_k = cb.shade_split_t(r["xt"], *args6, n_alive=r["n_alive"])
        o_p = cb.cbody_shade_reference(r["xt"], *args6,
                                       n_alive=r["n_alive"])
        eq.append(("K6", b, bit_diff(o_k, o_p), bit_diff(o_k, r["out"])))
        r = tex_b[2][b]
        h_k = cb.hit_shade_t(r["xt"], tex_b[0].stab)
        h_p = cb.cbody_hit_reference(r["xt"], tex_b[0].stab)
        eq.append(("K5", b, bit_diff(h_k, h_p), bit_diff(h_k, r["out"])))
    if any(e[2] or e[3] for e in eq):
        raise AssertionError(f"K3 / K5 / K6 past the cap: {eq}")
    lap("K3 / K5 / K6")

    # K4 on the same two sets, a seeded cotangent in every column, under
    # phase 7's rules
    gen = torch.Generator().manual_seed(19)
    k4 = []
    for b in (0, 3):
        r = fused_b[1][b]
        ct = torch.randn(cb.OUT_COLS, n, generator=gen).to(dev)
        row = k4_compare(r["xt"], (ds_b.ltab, ds_b.mtab, ds_b.stab), ct,
                         (ds_b.static,) + shade_cfg + (r["n_alive"],))
        k4.append(dict(bounce=b, **row))
        if not k4_ok(row):
            raise AssertionError(f"K4 past the cap, bounce {b}: {row}")
    lap("K4")

    # each kernel's time past the cap beside cb.json's, in the same run:
    # ms by CUDA events (inputs rotated past the L2), device ms by the
    # profiler, and the bound (phase 3 / 7 / 9's work counts)
    def times(name, dsx):
        fused, tex = waves[name]["fused"], waves[name]["textured"]
        out = {}
        qs = fuzz.wave_queries(dsx, cam_b, film_b, cfg_b, integ.KERNEL_OPS)
        tbytes = 4 * (dsx.cbox.numel() + dsx.ktab.numel())
        for kind, key in (("closest", "K1"), ("any", "K2")):
            q = next(q for q in qs if q["kind"] == kind)
            m = n if q["n_alive"] is None else int(q["n_alive"])
            od = torch.stack([q["o"], q["d"]])
            if kind == "closest":
                call = rotating(lambda x: ops.closest_hit(
                    dsx.cw, dsx.cbox, x[0], x[1], q["tmax"], q["n_alive"],
                    sph_tab=dsx.ktab, full_phi=dsx.full_phi), od)
                wb, tri = closest_work(dsx.cw, dsx.cbox, q["o"][:m],
                                       q["d"][:m], q["t"][:m])
            else:
                call = rotating(lambda x: ops.any_hit(
                    dsx.cw, dsx.cbox, x[0], x[1], q["tmax"], q["n_alive"],
                    sph_tab=dsx.ktab, full_phi=dsx.full_phi), od)
                # the triangles of the rays no sphere blocks
                free = sph.sphere_best(dsx.ktab, q["o"][:m], q["d"][:m],
                                       q["tmax"][:m], dsx.full_phi)[1] == -1
                wb, tri = any_work(
                    dsx.cw, dsx.cbox, q["o"][:m][free], q["d"][:m][free],
                    q["tmax"][:m][free])
            # the sphere branch: each row the same operations on the
            # live rays
            sph_ops = sphere_ops(dsx.ktab, q["o"][:m], q["d"][:m],
                                 q["tmax"][:m], dsx.full_phi)
            dev_ms, _ = kernel_ms(call, "cluster_kernel")
            out[key] = dict(ms=time_ms(call), device_ms=dev_ms, live=m,
                            bound=bound_ms(
                                4 * n * (7 + (2 if kind == "closest" else 1))
                                + tbytes + wb, tri + sph_ops))
        r0 = fused[1][0]
        tabs = (dsx.ltab, dsx.mtab, dsx.stab)
        tab_bytes = 4 * sum(t.numel() for t in tabs)
        call = rotating(lambda x: ops.bounce_shade(
            x, *tabs, dsx.static, *shade_cfg, n_alive=r0["n_alive"]),
            r0["xt"])
        ct = torch.randn(cb.OUT_COLS, n, generator=gen).to(dev)
        k4_args = (r0["xt"], *tabs, ct, dsx.static, *shade_cfg,
                   r0["n_alive"])
        stats = {}
        ops.bounce_shade_bwd(*k4_args, stats=stats)
        _, nodes, listed = stats["nodes"].tolist()
        dev_ms, _ = kernel_ms(call, "bounce_shade_kernel")
        # every live lane taped: the node total counts the forward's
        # operations
        out["K3"] = dict(ms=time_ms(call), device_ms=dev_ms, bound=bound_ms(
            4 * n * (cb.IN_COLS + cb.OUT_COLS) + tab_bytes, nodes))
        out["K4"] = dict(
            ms=time_ms(lambda: ops.bounce_shade_bwd(*k4_args), iters=3),
            device_ms=k4_device_ms(lambda: ops.bounce_shade_bwd(*k4_args)),
            bound=bound_ms(4 * (listed * cb.IN_COLS + (n - listed) * 5)
                           + 4 * n * (28 + cb.IN_COLS) + 2 * tab_bytes, 0))
        dst, xh, xs = tex[0], tex[2][0]["xt"], tex[1][0]
        call = rotating(lambda x: ops.hit_shade(x, dst.stab), xh)
        dev_ms, _ = kernel_ms(call, "hit_shade_kernel")
        out["K5"] = dict(ms=time_ms(call), device_ms=dev_ms, bound=bound_ms(
            4 * n * (cb.HIT_IN_COLS + cb.HIT_OUT_COLS)
            + 4 * dst.stab.numel(),
            plain_ops(lambda: cb.cbody_hit_reference(xh, dst.stab))))
        args6 = (dst.ltab, dst.static) + shade_cfg
        call = rotating(lambda x: ops.shade_split(
            x, *args6, n_alive=xs["n_alive"]), xs["xt"])
        dev_ms, _ = kernel_ms(call, "shade_split_kernel")
        out["K6"] = dict(ms=time_ms(call), device_ms=dev_ms, bound=bound_ms(
            4 * n * (cb.SHADE_IN_COLS + cb.OUT_COLS) + 4 * dst.ltab.numel(),
            plain_ops(lambda: cb.cbody_shade_reference(
                xs["xt"], *args6, n_alive=xs["n_alive"]))))
        return out

    ktimes = {name: times(name, dsx)
              for name, dsx in (("lights", ds_b), ("cb.json", ds_c))}
    for name, rows in ktimes.items():
        for k, r in rows.items():
            if r["ms"] < r["bound"][0]:
                raise AssertionError(f"{k} on {name}: {r['ms']} ms is below "
                                     f"its bound {r['bound']}")
    lap("times")

    # the whole paths at 64x48, kernels against plain
    _, ds_r, cam_r, film_r, cfg_r = parse("lights", 4, (64, 48), 8)
    ops.reset_counts()
    img_k = integ.render(ds_r, cam_r, film_r, cfg_r)
    torch.cuda.synchronize()
    render_launches = ops.counts()
    img_p = integ.render(ds_r, cam_r, film_r, cfg_r, ops=integ.PLAIN_OPS)
    drender = float((img_k - img_p).abs().max().item())
    if not torch.isfinite(img_k).all() or img_k.shape != (48, 64, 3) \
            or not img_k.max() > 0.0 or drender > PLAIN_ATOL \
            or min(render_launches[k] for k in FORWARD_KERNELS) < 1:
        raise AssertionError(f"phase 19 render: diff {drender}, "
                             f"{render_launches}")
    lap("render")
    n_r = 64 * 48 * 4
    m_r = ds_r.materials
    p_r = {k: torch.tensor(v, device=dev) for k, v in
           (("kd", m_r.kd), ("ks", m_r.ks), ("roughness", m_r.roughness))}
    grads, losses = {}, {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        step = mesh.train_step_fn(ds_r, cam_r, film_r, cfg_r, lr=GRAD_LR,
                                  ops=wops)
        if name == "kernels":
            ops.reset_counts()
        new, loss = step(dict(p_r), img_k.reshape(-1, 3) * 0.8,
                         torch.arange(n_r, device=dev))
        torch.cuda.synchronize()
        if name == "kernels":
            step_launches = ops.counts()
        grads[name] = {k: (p_r[k] - new[k]) / GRAD_LR for k in new}
        losses[name] = loss.item()
    grel = {k: grad_rel(grads["kernels"][k], grads["plain"][k]) for k in p_r}
    finite = all(torch.isfinite(g).all().item()
                 for gs in grads.values() for g in gs.values())
    if not finite or max(grel.values()) > GRAD_GATE \
            or min(step_launches[k] for k in TRAIN_KERNELS) < 1:
        raise AssertionError(f"phase 19 train step: grad rel {grel}, finite "
                             f"{finite}, {step_launches}")
    lap("train step")
    # Whitted (one shadow ray a light: on the unlit spheres, cb.json's two
    # lights) and BPT, kernels against plain
    _, ds_w, cam_w, film_w, cfg_w = parse("unlit", 4, (64, 48), 8)
    _, ds_t, cam_t, film_t, cfg_t = parse("lights", BIG_BPT[1], BIG_BPT[0],
                                          BIG_BPT[2])
    other = {}
    for name, render, args, need in (
            ("Whitted", whitted.render_whitted,
             (ds_w, cam_w, film_w, cfg_w),
             SPHERE_KERNELS + ("closest_hit", "any_hit", "slot_eval_pdf")),
            ("BPT", bpt.render_bpt, (ds_t, cam_t, film_t, cfg_t),
             COMPOSED_KERNELS)):
        ops.reset_counts()
        img = render(*args)
        torch.cuda.synchronize()
        lau = ops.counts()
        diff = float((img - render(*args, ops=integ.PLAIN_OPS)).abs().max()
                     .item())
        other[name] = dict(dplain=diff, launches=lau)
        if not torch.isfinite(img).all() or not img.max() > 0.0 \
                or diff > PLAIN_ATOL or min(lau[k] for k in need) < 1 \
                or lau["bounce_shade"]:
            raise AssertionError(f"phase 19 {name}: {other[name]}")
        lap(name)

    # the 17 x 17 grid: 4,096 camera rays (64 x 64 pixels) and their first
    # bounce's shadow rays, the world K1 / K2 (578 spheres, no cluster)
    # and the instanced entries equal to their plain versions on every
    # lane; its render, kernels against plain
    s_g, ds_g, cam_g, film_g, cfg_g = parse("grid", 1, (64, 64), 8)
    im = ds_g.inst[0]
    n4 = 4096
    pid4 = torch.arange(n4, device=dev)
    ws4 = smp.WaveSampler(smp.make_base_key(0), pid4, torch.zeros_like(pid4),
                          sample_dx=1, sample_dy=1)
    pxy4 = torch.stack([(pid4 % 64).float(), (pid4 // 64).float()], -1)
    o4, d4 = cam.generate_rays(cam_g, pxy4 + ws4.film_jitter(), ws4.u2(2))
    raw4 = integ.intersect_raw(ds_g, o4, d4, None, integ.KERNEL_OPS)
    u_s, u_l, u_b, u_r = integ.bounce_draws(cfg_g, ws4.keys, 0)
    li4, sp4 = nee.sample_one_light(ds_g, u_s)
    r4 = cb.unpack_out_t(cb.bounce_shade_t(
        integ.pack_bounce_input(integ.initial_carry(o4, d4, ws4.keys), raw4,
                                li4, sp4, u_l, u_b, u_r, 0),
        ds_g.ltab, ds_g.mtab, ds_g.stab, ds_g.static, *shade_cfg))
    gkw = dict(sph_tab=ds_g.ktab, full_phi=ds_g.full_phi)
    grid = []
    for nm_, o_, d_, tm_ in (
            ("camera", o4, d4, torch.full((n4,), float("inf"), device=dev)),
            ("shadow",) + tuple(r4[k].contiguous()
                                for k in ("sh_o", "sh_d", "sh_t"))):
        wa = (ds_g.cw, ds_g.cbox, o_, d_, tm_, None)
        world_k = results(ci.intersect_clusters(*wa, **gkw)) \
            + results(ci.occluded_clusters(*wa, **gkw))
        world_p = results(ci.intersect_clusters_reference(*wa, **gkw)) \
            + results(ci.occluded_clusters_reference(*wa, **gkw))
        ia = (im.cw, im.cbox, im.itab, o_, d_, tm_, None)
        inst_k = ci.intersect_instanced(*ia) \
            + (ci.occluded_instanced(*ia, world_k[2]),)
        inst_p = ci.intersect_instanced_reference(*ia) \
            + (ci.occluded_instanced_reference(*ia, world_p[2]),)
        grid.append(dict(
            set=nm_, world_equal=all(torch.equal(a, b_)
                                     for a, b_ in zip(world_k, world_p)),
            instanced_equal=all(torch.equal(a, b_)
                                for a, b_ in zip(inst_k, inst_p)),
            inst_hit=(inst_k[1] >= 0).float().mean().item(),
            inst_blocked=inst_k[3].float().mean().item(),
            sphere_lanes=int((world_k[1] <= -2).sum())))
        if not (grid[-1]["world_equal"] and grid[-1]["instanced_equal"]):
            raise AssertionError(f"phase 19 grid: {grid[-1]}")
    lap("grid queries")
    _, ds_gr, cam_gr, film_gr, cfg_gr = parse("grid", BIG_GRID[1],
                                              BIG_GRID[0], BIG_GRID[2])
    ops.reset_counts()
    img_g = integ.render(ds_gr, cam_gr, film_gr, cfg_gr)
    torch.cuda.synchronize()
    grid_launches = ops.counts()
    dgrid = float((img_g - integ.render(ds_gr, cam_gr, film_gr, cfg_gr,
                                        ops=integ.PLAIN_OPS))
                  .abs().max().item())
    if not torch.isfinite(img_g).all() or not img_g.max() > 0.0 \
            or dgrid > PLAIN_ATOL \
            or min(grid_launches[k] for k in INSTANCED_KERNELS) < 1:
        raise AssertionError(f"phase 19 grid render: {dgrid}, "
                             f"{grid_launches}")
    lap("grid render")

    def ktext(name):
        return ", ".join(
            f"{k} {r['ms']:.4f} ms (device {r['device_ms']:.4f}, bound "
            f"{r['bound'][0]:.4f} {r['bound'][1]})"
            for k, r in ktimes[name].items())
    _say(f"[19] tables past the caps (lights: ltab {tuple(ds_b.ltab.shape)},"
         f" mtab {tuple(ds_b.mtab.shape)}, ktab {tuple(ds_b.ktab.shape)}): "
         "plans " + ", ".join(f"{k} staged {p.staged:03b} {p.smem} B"
                              for k, p in plans.items())
         + f", K1 / K2 {-(-ds_b.ktab.shape[0] // 512)} sphere chunks of <= "
         "512 rows (intersect.cu SPH_CHUNK); "
         "shared memory and blocks per SM " + ", ".join(
             f"{k} {v['smem']} B {v['blocks_per_sm']}"
             for k, v in occ.items())
         + f" | K1 / K2 on 65,536 sphere rays (live {n - 9000}): codes agree "
         f"{fr:.6f} ({k12['sphere_lanes']} sphere lanes, {split} splits, "
         f"{tie} ties), blocked agree {k12['blocked_agree']:.6f} | equal to "
         "the bit (elements that differ from plain / from the wave's "
         "launch): " + ", ".join(f"{k} bounce {b} {x}/{y}"
                                 for k, b, x, y in eq)
         + " | K4: " + "; ".join(
             f"bounce {r['bounce']} dx close {r['dx_close']:.6f}, table rel "
             + "/".join(f"{x:.2e}" for x in r["table_rel"])
             + f", taped {r['listed']}" for r in k4)
         + f" | per launch, past the cap: {ktext('lights')}; cb.json: "
         f"{ktext('cb.json')} | 64x48 render vs plain {drender:.2e}, train "
         f"step grad rel " + ", ".join(f"{k} {v:.2e}" for k, v in grel.items())
         + ", " + ", ".join(f"{k} vs plain {v['dplain']:.2e}"
                            for k, v in other.items())
         + " | grid of 289: " + "; ".join(
             f"{r['set']}: world equal {r['world_equal']}, instanced equal "
             f"{r['instanced_equal']} (hit {r['inst_hit']:.3f}, blocked "
             f"{r['inst_blocked']:.3f}, sphere lanes {r['sphere_lanes']})"
             for r in grid) + f", render vs plain {dgrid:.2e} | seconds: "
         + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + f" ({card})")
    return dict(plans={k: dataclasses.asdict(p) for k, p in plans.items()},
                occupancy=occ, k12=k12,
                equal=eq, k4=k4,
                times={s: {k: dict(r, bound=list(r["bound"]))
                           for k, r in rows.items()}
                       for s, rows in ktimes.items()},
                render_dplain=drender, render_launches=render_launches,
                train_grad_rel=grel, train_losses=losses,
                train_launches=step_launches,
                textured_wave_launches=tex_b[3], other=other, grid=grid,
                grid_dplain=dgrid, grid_launches=grid_launches, seconds=laps)


def phase20(dev, card, big_tables, scratch, compat_golden):
    """Phase 20: area-uniform sphere-light sampling
    (ARENDUR_SPHERE_THETA=area: shapes/sphere.py THETA_UNIFORM_COMPAT
    False for the phase, so K3 / K4 / K6 launch with theta_compat 0 in
    their ShadeCfg), compat restored at its end.  compat_golden: phase
    5's (mse_ds4, |dmean|).  Returns the measurements; raises where a
    gate fails."""
    import numpy as np
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.parallel import mesh
    from arendur_tpu_torch.render import bpt, whitted
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.shapes import sphere as sph

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    n = 1 << 16
    cb_json = os.path.join(REPO, "examples/cornellbox/cb.json")
    paths = {"cb.json": cb_json,
             "lights": big_tables.write(os.path.join(scratch,
                                                     "area_lights.json"),
                                        big_tables.lights_desc())}

    def parse(name, spp, res, depth, wave=None):
        scene, camera, film, config, _ = scenedesc.parse_scene(
            paths[name], spp_override=spp, resolution_override=res)
        config = dataclasses.replace(
            config, max_depth=depth,
            wave_size=wave or res[0] * res[1] * spp)
        return scene, sc.DeviceScene.build(scene, dev), camera, film, config

    def theta_word(static):
        """The theta_compat word of the ShadeCfg the wrappers pack."""
        return int(ops.pack_shade_cfg(static, 4, 0.05,
                                      sph.THETA_UNIFORM_COMPAT)[-4])

    saved = sph.THETA_UNIFORM_COMPAT
    sph.THETA_UNIFORM_COMPAT = False
    try:
        # the golden configuration (phase 5's): kernels against plain, and
        # the distance to the golden beside the JAX package's in this mode
        s5, ds5, cam5, film5, cfg5 = parse("cb.json", 32, (64, 48), 8)
        word = theta_word(ds5.static)
        ops.reset_counts()
        img_k = integ.render(ds5, cam5, film5, cfg5)
        torch.cuda.synchronize()
        golden_launches = ops.counts()
        img_p = integ.render(ds5, cam5, film5, cfg5, ops=integ.PLAIN_OPS)
        dgold = float((img_k - img_p).abs().max().item())
        img_k = img_k.cpu().numpy()
        golden = np.load(os.path.join(
            REPO, "tests/data/cornell_golden_128x96.npy"))
        g64 = _block_mean(golden, 2)
        clip = np.clip(img_k, 0.0, 1.0)
        mse = float(((_block_mean(clip, 4) - _block_mean(g64, 4)) ** 2)
                    .mean())
        dmean = float(abs(clip.mean() - g64.mean()))
        near = [abs(v - r) / r for v, r in zip((mse, dmean), AREA_GOLDEN)]
        if word != 0 or not np.isfinite(img_k).all() \
                or img_k.shape != (48, 64, 3) or dgold > PLAIN_ATOL \
                or max(near) > AREA_GOLDEN_RTOL \
                or mse <= compat_golden[0] \
                or min(golden_launches[k] for k in FORWARD_KERNELS) < 1:
            raise AssertionError(
                f"phase 20 golden: theta_compat {word}, mse_ds4 {mse}, "
                f"|dmean| {dmean} (JAX {AREA_GOLDEN}, compat "
                f"{compat_golden}), vs plain {dgold}, {golden_launches}")
        lap("golden")

        # K3, K5, K6 equal to their plain versions to the bit, K4 under
        # phase 7's rules, on wave 0's first bounce and its compacted
        # bounce 3 (256x256, 16 spp, depth 8) of cb.json and of the
        # 2,500-light scene
        gen = torch.Generator().manual_seed(20)
        eq, k4, firsts = [], [], {}
        for name in ("cb.json", "lights"):
            s_x, ds_x, cam_x, film_x, cfg_x = parse(name, 16, (256, 256), 8,
                                                    n)
            shade_cfg = (cfg_x.min_depth, cfg_x.rr_threshold)
            hits = []

            def rec_hit(xt, stab):
                out = cb.hit_shade_t(xt, stab)
                hits.append(dict(xt=xt.detach().clone(), out=out.clone()))
                return out
            scene_t, atlas = fuzz.checker_textured(s_x, dev)
            ds_t = sc.DeviceScene.build(scene_t, dev)
            fused = fuzz.wave_shades(ds_x, cam_x, film_x, cfg_x,
                                     integ.KERNEL_OPS)
            tex = fuzz.wave_shades(
                ds_t, cam_x, film_x,
                dataclasses.replace(cfg_x, textures=atlas),
                dataclasses.replace(integ.KERNEL_OPS, hit_shade=rec_hit))
            tabs = (ds_x.ltab, ds_x.mtab, ds_x.stab)
            for b in (0, 3):
                r = fused[b]
                args3 = tabs + (ds_x.static,) + shade_cfg
                o_k = cb.bounce_shade_t(r["xt"], *args3, n_alive=r["n_alive"])
                o_p = cb.cbody_reference(r["xt"], *args3,
                                         n_alive=r["n_alive"])
                eq.append((name, "K3", b, bit_diff(o_k, o_p),
                           bit_diff(o_k, r["out"])))
                r6 = tex[b]
                args6 = (ds_t.ltab, ds_t.static) + shade_cfg
                o_k = cb.shade_split_t(r6["xt"], *args6,
                                       n_alive=r6["n_alive"])
                o_p = cb.cbody_shade_reference(r6["xt"], *args6,
                                               n_alive=r6["n_alive"])
                eq.append((name, "K6", b, bit_diff(o_k, o_p),
                           bit_diff(o_k, r6["out"])))
                h = hits[b]
                h_k = cb.hit_shade_t(h["xt"], ds_t.stab)
                h_p = cb.cbody_hit_reference(h["xt"], ds_t.stab)
                eq.append((name, "K5", b, bit_diff(h_k, h_p),
                           bit_diff(h_k, h["out"])))
                ct = torch.randn(cb.OUT_COLS, n, generator=gen).to(dev)
                row = k4_compare(r["xt"], tabs, ct, (ds_x.static,)
                                 + shade_cfg + (r["n_alive"],))
                k4.append(dict(scene=name, bounce=b, **row))
                if not k4_ok(row):
                    raise AssertionError(f"phase 20 K4, {name} bounce {b}: "
                                         f"{row}")
            firsts[name] = (ds_x, ds_t, fused[0], tex[0], shade_cfg)
        if any(e[3] or e[4] for e in eq):
            raise AssertionError(f"phase 20 K3 / K5 / K6: {eq}")
        lap("K3 / K4 / K5 / K6")

        # K3 / K6 / K4's device ms on each first bounce (the same inputs
        # in both modes: no light is sampled before it), area and compat
        # launch by launch in the same run
        def mode(compat, fn):
            def call():
                sph.THETA_UNIFORM_COMPAT = compat
                try:
                    return fn()
                finally:
                    sph.THETA_UNIFORM_COMPAT = False
            return call

        times = {}
        for name, (ds_x, ds_t, r3, r6, shade_cfg) in firsts.items():
            tabs = (ds_x.ltab, ds_x.mtab, ds_x.stab)
            k3 = rotating(lambda x: ops.bounce_shade(
                x, *tabs, ds_x.static, *shade_cfg, n_alive=r3["n_alive"]),
                r3["xt"])
            k6 = rotating(lambda x: ops.shade_split(
                x, ds_t.ltab, ds_t.static, *shade_cfg,
                n_alive=r6["n_alive"]), r6["xt"])
            ct = torch.randn(cb.OUT_COLS, n, generator=gen).to(dev)

            def k4_call():
                return ops.bounce_shade_bwd(r3["xt"], *tabs, ct, ds_x.static,
                                            *shade_cfg, r3["n_alive"])
            row = {}
            for key, fn, kname in (("K3", k3, "bounce_shade_kernel"),
                                   ("K6", k6, "shade_split_kernel"),
                                   ("K4", k4_call, None)):
                for label, compat in (("area", False), ("compat", True)):
                    f = mode(compat, fn)
                    row[f"{key} {label}"] = (
                        k4_device_ms(f) if kname is None
                        else kernel_ms(f, kname)[0])
            times[name] = row
        lap("times")

        # the paths at 64x48, kernels against plain
        _, ds_r, cam_r, film_r, cfg_r = parse("cb.json", AREA_SPP, (64, 48),
                                              8)
        n_r = 64 * 48 * AREA_SPP
        p_r = {k: torch.tensor(v, device=dev) for k, v in
               (("kd", ds_r.materials.kd), ("ks", ds_r.materials.ks),
                ("roughness", ds_r.materials.roughness))}
        target = torch.tensor(img_k, device=dev).reshape(-1, 3) * 0.8
        grads = {}
        for name, wops in (("kernels", integ.KERNEL_OPS),
                           ("plain", integ.PLAIN_OPS)):
            step = mesh.train_step_fn(ds_r, cam_r, film_r, cfg_r, lr=GRAD_LR,
                                      ops=wops)
            ops.reset_counts()
            new, _ = step(dict(p_r), target, torch.arange(n_r, device=dev))
            torch.cuda.synchronize()
            if name == "kernels":
                step_launches = ops.counts()
            grads[name] = {k: (p_r[k] - new[k]) / GRAD_LR for k in new}
        grel = {k: grad_rel(grads["kernels"][k], grads["plain"][k])
                for k in p_r}
        finite = all(torch.isfinite(g).all().item()
                     for gs in grads.values() for g in gs.values())
        if not finite or max(grel.values()) > GRAD_GATE \
                or min(step_launches[k] for k in TRAIN_KERNELS) < 1:
            raise AssertionError(f"phase 20 train step: grad rel {grel}, "
                                 f"finite {finite}, {step_launches}")
        lap("train step")

        s_t = parse("cb.json", AREA_SPP, (64, 48), 8)
        scene_t, atlas = fuzz.checker_textured(s_t[0], dev)
        tex_args = (sc.DeviceScene.build(scene_t, dev), s_t[2], s_t[3],
                    dataclasses.replace(s_t[4], textures=atlas))
        _, ds_b, cam_b, film_b, cfg_b = parse("cb.json", AREA_BPT[1],
                                              AREA_BPT[0], AREA_BPT[2])
        other = {}
        for name, render, args, need in (
                ("textured", integ.render, tex_args, TEXTURED_KERNELS),
                ("Whitted", whitted.render_whitted, s_t[1:],
                 SPHERE_KERNELS + ("closest_hit", "any_hit",
                                   "slot_eval_pdf")),
                ("BPT", bpt.render_bpt, (ds_b, cam_b, film_b, cfg_b),
                 COMPOSED_KERNELS)):
            ops.reset_counts()
            img = render(*args)
            torch.cuda.synchronize()
            lau = ops.counts()
            diff = float((img - render(*args, ops=integ.PLAIN_OPS)).abs()
                         .max().item())
            other[name] = dict(dplain=diff, launches=lau)
            if not torch.isfinite(img).all() or not img.max() > 0.0 \
                    or diff > PLAIN_ATOL or min(lau[k] for k in need) < 1 \
                    or lau["bounce_shade"]:
                raise AssertionError(f"phase 20 {name}: {other[name]}")
            lap(name)
    finally:
        sph.THETA_UNIFORM_COMPAT = saved
    restored = (sph.THETA_UNIFORM_COMPAT, theta_word(ds5.static))
    if restored != (True, 1):
        raise AssertionError(f"phase 20: compat not restored: {restored}")

    _say(f"[20] area-uniform sphere-light sampling (THETA_UNIFORM_COMPAT "
         f"False, theta_compat word {word}): golden 64x48 32spp depth 8 "
         f"mse_ds4 {mse:.3e}, |dmean| {dmean:.3e} (the JAX package's "
         f"{AREA_GOLDEN[0]:.2e} / {AREA_GOLDEN[1]:.2e}, off by "
         f"{near[0]:.3f} / {near[1]:.3f}; compat, phase 5: "
         f"{compat_golden[0]:.3e} / {compat_golden[1]:.3e}), kernels vs "
         f"plain {dgold:.2e}, launches {golden_launches} | equal to the bit"
         " (elements that differ from plain / from the wave's launch): "
         + ", ".join(f"{s_} {k} bounce {b} {x}/{y}" for s_, k, b, x, y in eq)
         + " | K4: " + "; ".join(
             f"{r['scene']} bounce {r['bounce']} dx close "
             f"{r['dx_close']:.6f}, table rel "
             + "/".join(f"{x:.2e}" for x in r["table_rel"])
             + f", taped {r['listed']}" for r in k4)
         + " | device ms on the first bounce, area / compat: " + "; ".join(
             f"{s_}: " + ", ".join(
                 f"{k} {row[k + ' area']:.4f} / {row[k + ' compat']:.4f}"
                 for k in ("K3", "K6", "K4"))
             for s_, row in times.items())
         + f" | 64x48 {AREA_SPP}spp train step grad rel " + ", ".join(
             f"{k} {v:.2e}" for k, v in grel.items())
         + ", " + ", ".join(f"{k} vs plain {v['dplain']:.2e}"
                            for k, v in other.items())
         + f" | compat restored (THETA_UNIFORM_COMPAT {restored[0]}, "
         f"theta_compat word {restored[1]}) | seconds: "
         + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + f" ({card})")
    return dict(theta_word=word, mse_ds4=mse, dmean=dmean, golden_off=near,
                golden_dplain=dgold, golden_launches=golden_launches,
                equal=eq, k4=k4, times=times, train_grad_rel=grel,
                train_launches=step_launches, other=other, seconds=laps)


@contextlib.contextmanager
def timed_calls(module, name, into):
    """module.name wrapped to add each call's seconds to into[name]."""
    fn = getattr(module, name)
    into[name] = 0.0

    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            into[name] += time.perf_counter() - t0
    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, fn)


def subset_query(q, rays):
    """The recorded query q cut to `rays` of its live rays, evenly spaced
    (all live: no live count)."""
    import torch
    na = q["o"].shape[0] if q["n_alive"] is None else int(q["n_alive"])
    idx = torch.arange(rays, device=q["o"].device) * max(na // rays, 1)
    idx = idx[idx < na]
    return dict(q, o=q["o"][idx].contiguous(), d=q["d"][idx].contiguous(),
                tmax=q["tmax"][idx].contiguous(), n_alive=None)


def phase21(dev, card, scratch, tris=BIG_TRIS):
    """Phase 21: a mesh of about a million triangles
    (tools/make_big_mesh.py: cb.json's short box replaced by a displaced
    sphere of 998,000 triangles) loaded through parse_scene and
    DeviceScene.build, the CLI's path, with the native BVH build (the
    seconds of the write, the parse, the native builds and the upload,
    on the host's CPU); its 20,000-triangle cut built natively and by
    the NumPy build, every array equal; one 256x256, 1 spp, depth-8 wave
    (65,536 lanes) through the kernels, K1, K2 and K3 launched in it, the
    image finite with a positive mean; K1 / K2 against their plain
    versions on BIG_SUBSET rays of wave 0's camera query, its first
    bounce's shadow query and its first continuation query
    (K1_K2_GATE, T_RTOL); K1 / K2's ms per launch on those whole queries
    by CUDA events and on the card, against the bound.  Returns the
    measurements; raises where a gate fails."""
    import numpy as np
    import torch
    from arendur_tpu_torch import native
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.accel import bvh as bvhmod
    from arendur_tpu_torch.accel import clusters
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_big_mesh
    from host_cpu import host_cpu

    cpu = host_cpu()
    secs = {}
    t0 = time.perf_counter()
    path = make_big_mesh.write(os.path.join(scratch, "big_mesh"), tris)
    secs["write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timed_calls(clusters, "build_clusters", secs), \
            timed_calls(native, "build_bvh", secs):
        scene, camera, film, config, _ = scenedesc.parse_scene(
            path, spp_override=1, resolution_override=BIG_RES)
    secs["parse_scene"] = time.perf_counter() - t0
    config = dataclasses.replace(config, max_depth=BIG_DEPTH,
                                 wave_size=BIG_RES[0] * BIG_RES[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = sc.DeviceScene.build(scene, dev)
    torch.cuda.synchronize()
    secs["upload"] = time.perf_counter() - t0
    n_tris, n_clusters = scene.n_tris, ds.cw.shape[0]
    if n_tris < 0.9 * tris or n_clusters < tris // (2 * clusters.DEFAULT_K):
        raise AssertionError(f"phase 21: the big mesh holds {n_tris} "
                             f"triangles in {n_clusters} clusters")

    # the 20,000-triangle cut: native against the NumPy build
    cut = [np.ascontiguousarray(v[:BIG_CUT]) for v in
           (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    t0 = time.perf_counter()
    b_nat = bvhmod.build_bvh(*cut)
    secs["cut_native"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_pl = bvhmod.build_bvh_plain(*cut)
    secs["cut_plain"] = time.perf_counter() - t0
    unequal = [f for f in ("bmin", "bmax", "second", "start", "count",
                           "axis", "order")
               if not np.array_equal(getattr(b_nat, f), getattr(b_pl, f))]
    if unequal:
        raise AssertionError(f"phase 21: the native and NumPy builds of the "
                             f"{BIG_CUT}-triangle cut differ in {unequal}")

    # one wave through the kernels (the main path of this scene)
    ops.reset_counts()
    t0 = time.perf_counter()
    img = integ.render(ds, camera, film, config)
    torch.cuda.synchronize()
    secs["wave"] = time.perf_counter() - t0
    launches = ops.counts()
    img = img.cpu().numpy()
    if not np.isfinite(img).all() or not img.mean() > 0.0 \
            or img.shape != (BIG_RES[1], BIG_RES[0], 3):
        raise AssertionError(f"phase 21: the wave's image is not finite "
                             f"with a positive mean: {img.shape}, mean "
                             f"{img.mean()}")
    if min(launches[k] for k in ("closest_hit", "any_hit",
                                 "bounce_shade")) < 1:
        raise AssertionError(f"phase 21: a kernel was not launched: "
                             f"{launches}")

    # wave 0's queries: K1 / K2 against their plain versions on subsets,
    # and timed on the whole queries
    t0 = time.perf_counter()
    queries = fuzz.wave_queries(ds, camera, film, config, integ.KERNEL_OPS)
    closest = [q for q in queries if q["kind"] == "closest"]
    picked = {"camera": closest[0],
              "shadow": next(q for q in queries if q["kind"] == "any"),
              "bounce 1": closest[1]}
    agree, times = {}, {}
    for name, q in picked.items():
        is_k1 = q["kind"] == "closest"
        sub = subset_query(q, BIG_SUBSET)
        got = results(query_call(ops.closest_hit if is_k1 else ops.any_hit,
                                 ds, sub)())
        ref = results(query_call(
            ci.intersect_clusters_reference if is_k1
            else ci.occluded_clusters_reference, ds, sub)())
        lanes = (got[-1] == ref[-1]).float().mean().item()
        trel = 0.0
        if is_k1:
            hit = (got[1] == ref[1]) & (got[1] >= 0)
            if hit.any():
                trel = ((got[0] - ref[0]).abs()[hit]
                        / ref[0].abs()[hit]).max().item()
        agree[name] = dict(kernel="K1" if is_k1 else "K2",
                           rays=sub["o"].shape[0], lanes_equal=lanes,
                           t_rel=trel)
        if lanes < K1_K2_GATE or trel > T_RTOL:
            raise AssertionError(f"phase 21 {name}: {agree[name]}")
        call = query_call(ops.closest_hit if is_k1 else ops.any_hit, ds, q)
        nbytes, nops = wave_query_work(ds, q, results(call()))
        b_ms, b_by = bound_ms(nbytes, nops)
        dev_ms, _ = kernel_ms(call, "cluster_kernel")
        times[name] = dict(kernel=agree[name]["kernel"],
                           live=q["o"].shape[0] if q["n_alive"] is None
                           else int(q["n_alive"]), ms=time_ms(call),
                           device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by)
    secs["queries"] = time.perf_counter() - t0
    _say(f"[21] big mesh (tools/make_big_mesh.py): T {n_tris} triangles, C "
         f"{n_clusters} clusters (w_chunks {tuple(ds.cw.shape)}, "
         f"{ds.cw.numel() * 4 / 2 ** 20:.0f} MiB) | host seconds ({cpu}): "
         f"write {secs['write']:.2f}, parse_scene {secs['parse_scene']:.2f} "
         f"(of it build_clusters {secs['build_clusters']:.2f}, of that the "
         f"native BVH build {secs['build_bvh']:.2f}), upload "
         f"{secs['upload']:.2f}; the {BIG_CUT}-triangle cut: native "
         f"{secs['cut_native']:.4f} s, NumPy {secs['cut_plain']:.2f} s, "
         f"every array equal | one {BIG_RES[0]}x{BIG_RES[1]} 1spp depth-"
         f"{BIG_DEPTH} wave through the kernels: {secs['wave']:.2f} s, "
         f"launches {({k: v for k, v in launches.items() if v})}, image mean "
         f"{img.mean():.4f} | K1 / K2 "
         f"against plain on {BIG_SUBSET}-ray subsets: " + "; ".join(
             f"{v['kernel']} {k}: lanes equal {v['lanes_equal']:.6f}, max t "
             f"rel {v['t_rel']:.2e}" for k, v in agree.items())
         + " | per launch on wave 0's whole queries: " + "; ".join(
             f"{v['kernel']} {k} ({v['live']} live rays): {v['ms']:.4f} ms "
             f"by events, {v['device_ms']:.4f} ms on the card, bound "
             f"{v['bound_ms']:.4f} ms ({v['bound_by']})"
             for k, v in times.items())
         + f" | queries {secs['queries']:.1f} s ({card})")
    for v in times.values():
        if v["bound_ms"] > v["ms"]:
            raise AssertionError(f"phase 21: {v} is below its bound")
    return dict(n_tris=n_tris, n_clusters=n_clusters, host_cpu=cpu,
                seconds=secs, launches=launches, image_mean=float(img.mean()),
                agree=agree, times=times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json and the image")
    out_dir = ap.parse_args(argv).out
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import numpy as np
    import make_cb_big_tables as big_tables
    # the scenes phases 14 and 19 write (tools/make_cb_big_tables.py)
    scratch_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    scratch = scratch_dir.name
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import build, ops
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.filming import camera as cam
    from arendur_tpu_torch.sampling import sampler as smp
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    from arendur_tpu_torch.lighting import nee
    from arendur_tpu_torch import materials as mats

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    # phase 1
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")
    _say(f"[1] card: {card}; torch {torch.__version__}, "
         f"cuda {torch.version.cuda}; device count "
         f"{torch.cuda.device_count()}")

    # phase 2
    t0 = time.perf_counter()
    built = build.build(report=True)
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report([log for _, log in built])

    cb_json = os.path.join(REPO, "examples/cornellbox/cb.json")
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        cb_json, spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    # K1 / K2 (32 rays a block: one a thread, 8 warps): dynamic shared
    # memory of a block and blocks per SM, the same with a sphere table of
    # any size (its chunks staged in the ring's space: intersect.cu
    # SPH_CHUNK)
    occ = {}
    for kind in ("K1", "K2"):
        occ[f"{kind} any sphere count"] = ops.isect_occupancy(kind == "K2")
    # the instanced K1 / K2 over 100 instances (cb_inst.json: the table
    # staged in shared memory) and 1,000 (its first rows staged)
    for ni in (100, 1000):
        for kind in ("K1", "K2"):
            occ[f"{kind} instanced {ni} instances"] = \
                ops.isect_inst_occupancy(kind == "K2", ni)
    if min(blocks for _, blocks in occ.values()) < 1:
        raise AssertionError(f"K1 / K2: no block fits an SM: {occ}")
    # K3 / K6 with cb.json's tables, K3 with the 45-row box's (phase 13):
    # every table staged
    ds45 = sc.DeviceScene.build(fuzz.spread_materials(scene), dev)
    shade_occ = {"K3": ops.shade_occupancy(ds.ltab, ds.mtab, ds.stab),
                 "K6": ops.shade_occupancy(ds.ltab),
                 "K3 45-row box": ops.shade_occupancy(ds45.ltab, ds45.mtab,
                                                      ds45.stab)}
    if min(v["blocks_per_sm"] for v in shade_occ.values()) < 1 \
            or shade_occ["K6"]["staged"] != ops.STAGE_L or any(
                shade_occ[k]["staged"] != ops.STAGE_ALL
                for k in ("K3", "K3 45-row box")):
        raise AssertionError(f"K3 / K6: no block fits an SM, or a table "
                             f"under the cap not staged: {shade_occ}")
    _say(f"[2] kernels built in {build_s:.1f} s "
         f"({', '.join(os.path.relpath(p, REPO) for p, _ in built)}); "
         + " | ".join(f"{k}: {v}" for k, v in ptxas.items())
         + " | K1 / K2 blocks of 8 warps, one ray a thread (dynamic shared "
         "memory B, blocks per SM): " + ", ".join(
             f"{k} {v}" for k, v in occ.items())
         + " | K3 / K6 with cb.json's tables (K3 also the 45-row box's), "
         "every table staged: " + ", ".join(
             f"{k} {v['smem']} B shared, {v['blocks_per_sm']} blocks per SM,"
             f" {v['registers']} registers, {v['local_bytes']} B local a "
             f"thread" for k, v in shade_occ.items()))
    n = 1 << 16
    rng = np.random.default_rng(0)

    # a real first wave: camera rays of pixels 0..4095 at 16 spp
    ray_idx = torch.arange(n, device=dev)
    pid, sid = ray_idx // 16, ray_idx % 16
    pxy = torch.stack([(pid % 256).float(), (pid // 256).float()], -1)
    ws = smp.WaveSampler(smp.make_base_key(0), pid, sid, sample_dx=4,
                         sample_dy=4)
    o_cam, d_cam = cam.generate_rays(camera, pxy + ws.film_jitter(),
                                     ws.u2(2))
    tinf = torch.full((n,), float("inf"), device=dev)

    # phase 3: K1 / K2
    kern_rows = {}
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o_sec = torch.tensor(rng.uniform([-1.9, -1.4, 2.1], [1.9, 2.4, 5.9],
                                     (n, 3)), dtype=torch.float32,
                         device=dev)
    d_sec = torch.tensor(dirs, dtype=torch.float32, device=dev)
    n_alive = torch.tensor(n - 9000, device=dev)
    k1 = []
    for name, o_, d_, na in (("camera", o_cam, d_cam, None),
                             ("secondary", o_sec, d_sec, n_alive)):
        t_k, s_k = ci.intersect_clusters(ds.cw, ds.cbox, o_, d_, tinf, na)
        t_p, s_p = ci.intersect_clusters_reference(ds.cw, ds.cbox, o_, d_,
                                                   tinf, na)
        agree = (s_k == s_p)
        frac = agree.float().mean().item()
        hit = agree & (s_k >= 0)
        terr = (t_k - t_p).abs()[hit]
        trel = (terr / t_p.abs()[hit]).max().item() if hit.any() else 0.0
        k1.append((name, frac, trel, terr.max().item() if hit.any()
                   else 0.0, hit.float().mean().item()))
        if frac < K1_K2_GATE or trel > T_RTOL:
            raise AssertionError(f"K1 {name}: slots agree on {frac}, "
                                 f"t rel err {trel}")
        if na is not None and (s_k[n - 9000:] != -1).any():
            raise AssertionError("K1 reported hits past n_alive")
    k1_ms = time_ms(lambda: ops.closest_hit(ds.cw, ds.cbox, o_cam, d_cam,
                                            tinf))
    k1_plain = time_ms(lambda: ci.intersect_clusters_reference(
        ds.cw, ds.cbox, o_cam, d_cam, tinf))
    t_cam, _ = ops.closest_hit(ds.cw, ds.cbox, o_cam, d_cam, tinf)
    k1_io = 4 * n * (7 + 2) + 4 * ds.cbox.numel()
    k1_wb, k1_ops = closest_work(ds.cw, ds.cbox, o_cam, d_cam, t_cam)
    k1_bound = bound_ms(k1_io + k1_wb, k1_ops)

    # real shadow rays: the first bounce of the wave, on the plain path
    carry = integ.initial_carry(o_cam, d_cam, ws.keys)
    raw = integ.intersect_raw(ds, o_cam, d_cam, None, integ.PLAIN_OPS)
    u_sel, u_l, u_b, u_rr = integ.bounce_draws(config, ws.keys, 0)
    lidx, selpdf = nee.sample_one_light(ds, u_sel)
    x0 = integ.pack_bounce_input(carry, raw, lidx, selpdf, u_l, u_b, u_rr,
                                 0)
    r0 = cb.unpack_out_t(cb.cbody_reference(
        x0, ds.ltab, ds.mtab, ds.stab, ds.static, config.min_depth,
        config.rr_threshold))
    sh = (r0["sh_o"].contiguous(), r0["sh_d"].contiguous(),
          r0["sh_t"].contiguous())
    tmax_sec = torch.tensor(rng.uniform(0.05, 6.0, n), dtype=torch.float32,
                            device=dev)
    k2 = []
    for name, (o_, d_, tm_), na in (("shadow", sh, None),
                                    ("secondary", (o_sec, d_sec, tmax_sec),
                                     n_alive)):
        b_k = ci.occluded_clusters(ds.cw, ds.cbox, o_, d_, tm_, na)
        b_p = ci.occluded_clusters_reference(ds.cw, ds.cbox, o_, d_, tm_,
                                             na)
        frac = (b_k == b_p).float().mean().item()
        k2.append((name, frac, b_k.float().mean().item()))
        if frac < K1_K2_GATE:
            raise AssertionError(f"K2 {name}: agree on {frac}")
    k2_ms = time_ms(lambda: ops.any_hit(ds.cw, ds.cbox, *sh))
    k2_plain = time_ms(lambda: ci.occluded_clusters_reference(
        ds.cw, ds.cbox, *sh))
    k2_io = 4 * n * (7 + 1) + 4 * ds.cbox.numel()
    k2_wb, k2_ops = any_work(ds.cw, ds.cbox, *sh)
    k2_bound = bound_ms(k2_io + k2_wb, k2_ops)
    # two launches equal to the bit
    twice = [all(torch.equal(a, b) for a, b in zip(results(f()),
                                                  results(f())))
             for f in (lambda: ops.closest_hit(ds.cw, ds.cbox, o_cam, d_cam,
                                               tinf),
                       lambda: ops.any_hit(ds.cw, ds.cbox, *sh))]
    if not all(twice):
        raise AssertionError(f"K1 / K2: two launches differ {twice}")

    # the queries of one fused wave (K1 / K2's main-path inputs, with the
    # sphere table): every lane against the plain version, a second
    # launch, and per query the time by events and on the card and the
    # bound.  K1's and K2's rows of the kernels line are their means.
    wave_q, _ = wave_query_rows(ds, fuzz.wave_queries(
        ds, camera, film_cfg, config, integ.KERNEL_OPS))
    if not all(r["recorded"] for r in wave_q):
        raise AssertionError(f"K1 / K2: a wave query's relaunch differs from "
                             f"the wave's own launch: {wave_q}")
    for name, kind in (("closest_hit", "closest"), ("any_hit", "any")):
        rows_k = [r for r in wave_q if r["kind"] == kind]
        mean = lambda key: sum(r[key] for r in rows_k) / len(rows_k)  # noqa
        kern_rows[name] = dict(
            max_abs_err=max(r["max_abs_err"] if kind == "closest"
                            else 1.0 - r["lanes_equal"] for r in rows_k),
            ms=mean("ms"), plain_ms=mean("plain_ms"),
            bound=bound_ms(mean("bytes"), mean("ops")))
    _say("[3] K1 " + "; ".join(
        f"{nm}: slots agree {fr:.6f}, max t rel {tr:.2e}, hit {h:.3f}"
        for nm, fr, tr, _, h in k1) + f"; {k1_ms:.3f} ms vs plain "
        f"{k1_plain:.3f} ms (bound {k1_bound[0]:.4f} ms) | K2 " + "; ".join(
        f"{nm}: agree {fr:.6f}, blocked {b:.3f}" for nm, fr, b in k2)
        + f"; {k2_ms:.3f} ms vs plain {k2_plain:.3f} ms (bound "
        f"{k2_bound[0]:.4f} ms); two launches equal {twice} | one fused "
        f"wave's queries (256x256 16spp depth 8, wave 0, sphere table): "
        + "; ".join(
            f"{'K1' if r['kind'] == 'closest' else 'K2'} live {r['live']}: "
            f"lanes equal to plain {r['lanes_equal']:.6f}, relaunch and "
            f"wave equal {r['relaunch'] and r['recorded']}, {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}, queued {r['queued_ms']:.4f}) vs bound "
            f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms"
            for r in wave_q)
        + f"; K1 + K2 device ms over the wave's {len(wave_q)} queries "
        f"{sum(r['device_ms'] for r in wave_q):.3f} ({card})")

    # phase 4: K3
    b2 = fuzz.all_branches_scene(sc.SceneBuilder())
    ds2 = sc.DeviceScene.build(b2, dev)
    k3 = []
    k3_err = 0.0
    flag_cols = (12, 13, 16, 24)
    cases = [("first bounce", x0, ds, None)]
    for nm, dsx in (("fuzz cornell", ds), ("fuzz all-branches", ds2)):
        xf = fuzz.fuzz_bounce_inputs(dsx.ltab.cpu().numpy(),
                                     dsx.mtab.cpu().numpy(),
                                     dsx.stab.cpu().numpy(), seed=0, n=n)
        cases.append((nm, torch.tensor(xf.T.copy(), device=dev), dsx, None))
    # a compacted mid-wave set: bounce 3 of wave 0, the lanes past its
    # live count under the dead-lane contract
    mid = fuzz.wave_shades(ds, camera, film_cfg, config,
                           integ.KERNEL_OPS)[3]
    cases.append((f"wave 0 bounce 3 (live {int(mid['n_alive'])})",
                  mid["xt"], ds, mid["n_alive"]))
    for nm, xt, dsx, na in cases:
        args = (dsx.ltab, dsx.mtab, dsx.stab, dsx.static, config.min_depth,
                config.rr_threshold)
        out_k = cb.bounce_shade_t(xt, *args, n_alive=na)
        out_p = cb.cbody_reference(xt, *args, n_alive=na)
        both_nan = torch.isnan(out_k) & torch.isnan(out_p)
        close = torch.isclose(out_k, out_p, rtol=K3_RTOL, atol=K3_ATOL) \
            | both_nan
        frac = close.float().mean().item()
        flags = min((out_k[j] == out_p[j]).float().mean().item()
                    for j in flag_cols)
        diff = bit_diff(out_k, out_p)
        k3_err = max(k3_err, (out_k - out_p).abs()[close].max().item())
        k3.append((nm, frac, flags, diff))
        if frac < K3_GATE or flags < K3_GATE or diff:
            raise AssertionError(f"K3 {nm}: close {frac}, flags {flags}, "
                                 f"elements not equal to the bit {diff}")
    args0 = (ds.ltab, ds.mtab, ds.stab, ds.static, config.min_depth,
             config.rr_threshold)
    if bit_diff(cb.bounce_shade_t(mid["xt"], *args0, n_alive=mid["n_alive"]),
                mid["out"]):
        raise AssertionError("K3: a relaunch on the mid-wave set differs "
                             "from the wave's own launch")
    k3_ms = time_ms(lambda: ops.bounce_shade(x0, *args0))
    k3_plain = time_ms(lambda: cb.cbody_reference(x0, *args0), iters=3)
    kern_rows["bounce_shade"] = dict(max_abs_err=k3_err, ms=k3_ms,
                                     plain_ms=k3_plain)
    tab_bytes = 4 * (ds.ltab.numel() + ds.mtab.numel() + ds.stab.numel())
    _say("[4] K3 " + "; ".join(
        f"{nm}: close {fr:.6f}, flags {fl:.6f}, elements not equal to the "
        f"bit {df}" for nm, fr, fl, df in k3) + f"; {k3_ms:.4f} ms by "
        f"events vs plain {k3_plain:.3f} ms")

    # phase 5: the main path against the golden and the plain path
    golden = np.load(os.path.join(REPO,
                                  "tests/data/cornell_golden_128x96.npy"))
    g64 = _block_mean(golden, 2)
    s5, cam5, film5, cfg5, _ = scenedesc.parse_scene(
        cb_json, spp_override=32, resolution_override=(64, 48))
    cfg5 = dataclasses.replace(cfg5, max_depth=8, wave_size=64 * 48 * 32)
    ds5 = sc.DeviceScene.build(s5, dev)
    ops.reset_counts()
    img_k = integ.render(ds5, cam5, film5, cfg5)
    torch.cuda.synchronize()
    launches = ops.counts()
    img_p = integ.render(ds5, cam5, film5, cfg5, ops=integ.PLAIN_OPS)
    img_k = img_k.cpu().numpy()
    img_p = img_p.cpu().numpy()
    if not np.isfinite(img_k).all() or img_k.shape != (48, 64, 3):
        raise AssertionError("kernel-path render is not finite [48,64,3]")
    clip = np.clip(img_k, 0.0, 1.0)
    mse_ds4 = float(((_block_mean(clip, 4) - _block_mean(g64, 4)) ** 2)
                    .mean())
    dmean = float(abs(clip.mean() - g64.mean()))
    dplain = float(np.abs(img_k - img_p).max())
    if out_dir:
        np.save(os.path.join(out_dir, "cornell_64x48_kernels.npy"), img_k)
    _say(f"[5] main path 64x48 32spp depth 8: launches {launches}; "
         f"mse_ds4 {mse_ds4:.3e} (gate {MSE_DS4_GATE}), |dmean| "
         f"{dmean:.3e} (gate {MEAN_GATE}); max |kernel - plain| "
         f"{dplain:.3e} (gate {PLAIN_ATOL})")
    if min(launches[k] for k in FORWARD_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if mse_ds4 >= MSE_DS4_GATE or dmean >= MEAN_GATE:
        raise AssertionError("golden gate failed")
    if dplain > PLAIN_ATOL:
        raise AssertionError("kernel path and plain path disagree")

    # phase 6: throughput
    rates = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        integ.render(ds, camera, film_cfg,
                     dataclasses.replace(config, spp=1, sample_dx=1,
                                         sample_dy=1), ops=wops)
        torch.cuda.synchronize()
        with (sphere_tests_refused() if name == "kernels"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            img = integ.render(ds, camera, film_cfg, config, ops=wops)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if not torch.isfinite(img).all():
            raise AssertionError(f"{name} render not finite")
        rates[name] = 256 * 256 * 16 / dt
        if name == "kernels":
            img_full = img
    _say(f"[6] throughput 256x256 16spp depth 8: kernels "
         f"{rates['kernels']:.0f} paths/s (no sphere test outside K1 / "
         f"K2), plain {rates['plain']:.0f} paths/s ({card})")

    # phase 7: K4 against its plain version, on the four input sets of
    # phase 4 with a random cotangent in every column (every live lane
    # taped) and on the eight bounces of one kernel-path train step (kd
    # only, as phase 8's), whose cotangents let most lanes through
    # untaped; each set with its live count
    k4 = []
    k4_err = 0.0
    gen = torch.Generator().manual_seed(7)
    target = img_full.reshape(-1, 3)
    step_bounces = fuzz.train_step_bounces(
        ds, camera, film_cfg, config, integ.KERNEL_OPS, target,
        torch.arange(n, device=dev))
    k4_sets = [(nm, xt, (dsx.ltab, dsx.mtab, dsx.stab),
                torch.randn(cb.OUT_COLS, xt.shape[1], generator=gen).to(dev),
                dsx.static, na) for nm, xt, dsx, na in cases]
    k4_sets += [(f"train bounce {b}", r["xt"], (r["ltab"], r["mtab"],
                                                r["stab"]), r["ct"],
                 ds.static, r["n_alive"])
                for b, r in enumerate(step_bounces)]
    for nm, xt, tabs, ct, static, na in k4_sets:
        shade_cfg = (static, config.min_depth, config.rr_threshold, na)
        r = k4_compare(xt, tabs, ct, shade_cfg)
        k4_err = max(k4_err, r.pop("err"))
        listed, total = r["listed"], r["nodes_total"]
        k4_ms = time_ms(lambda: ops.bounce_shade_bwd(xt, *tabs, ct,
                                                     *shade_cfg), iters=5)
        k4_dev = k4_device_ms(lambda: ops.bounce_shade_bwd(
            xt, *tabs, ct, *shade_cfg))
        k4_plain = None
        if not nm.startswith("fuzz"):
            k4_plain = time_ms(lambda: cb.cbody_vjp_reference(
                xt, *tabs, ct, *shade_cfg), iters=1)
        # K4's work: the gate columns of every lane's input (alive, hit,
        # is_sph, s_idx, the triangle's light id) and the rest of a
        # listed lane's, the 28 cotangent columns the body reads, dx
        # written, the tables read and their cotangents written
        bound = bound_ms(4 * (listed * cb.IN_COLS + (n - listed) * 5)
                         + 4 * n * (28 + cb.IN_COLS) + 2 * tab_bytes, 0)
        k4.append(dict(set=nm, ms=k4_ms, device_ms=k4_dev,
                       plain_ms=k4_plain, bound_ms=bound[0], **r))
        if not k4_ok(r):
            raise AssertionError(f"K4 {nm}: {k4[-1]}")
        if nm == "first bounce":
            # every lane taped: the node total counts the forward's
            # operations on every lane
            kern_rows["bounce_shade"]["bound"] = bound_ms(
                4 * n * (cb.IN_COLS + cb.OUT_COLS) + tab_bytes, total)
    train_k4 = [r for r in k4 if r["set"].startswith("train")]
    # K4's row: the mean per call over the train step's bounces, its
    # main-path input sets
    mean = lambda key: sum(r[key] for r in train_k4) / len(train_k4)
    kern_rows["bounce_shade_bwd"] = dict(
        max_abs_err=k4_err, ms=mean("ms"), plain_ms=mean("plain_ms"),
        bound=(mean("bound_ms"), "bytes"))
    k4_step_events = sum(r["ms"] for r in train_k4)
    k4_step_dev = sum(r["device_ms"] for r in train_k4)
    _say("[7] K4 " + "; ".join(
        f"{r['set']}: dx close {r['dx_close']:.6f} on the lanes taped, "
        f"pass-through exact {r['pass_through_exact']}, {r['dead_lanes']} "
        f"lanes past the live count with dx equal to the plain VJP "
        f"{r['dead_vjp_exact']}, table rel "
        + "/".join(f"{v:.2e}" for v in r["table_rel"])
        + f", bit-identical {r['bit_identical']}, {r['ms']:.3f} ms "
        f"(device {r['device_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms)"
        + (f" vs plain {r['plain_ms']:.3f} ms" if r["plain_ms"] else "")
        + f", lanes taped {r['listed']} (plain twin {r['listed_plain']}) "
        f"of {n}, tape nodes max {r['nodes_max']} mean "
        f"{r['nodes_total'] / max(r['listed'], 1):.0f} per taped lane, "
        f"let through with a non-finite plain VJP {r['skip_nonfinite']}"
        for r in k4) + f" | train step: K4 {k4_step_events:.3f} ms by "
        f"events, {k4_step_dev:.3f} ms on the card over its "
        f"{len(train_k4)} bounces ({card})")

    # phase 8: the train step
    from arendur_tpu_torch.parallel import mesh
    m5 = ds5.materials
    p5 = {k: torch.tensor(v, device=dev) for k, v in
          (("kd", m5.kd), ("ks", m5.ks), ("roughness", m5.roughness))}
    idx5 = torch.arange(64 * 48 * 32, device=dev)
    target5 = torch.tensor(img_k.reshape(-1, 3), device=dev)
    grads, losses = {}, {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        # a large step, so that (p - p_new) / lr keeps the gradient to
        # f32 precision (at lr 0.05 it would round to ulp(p) / 0.05)
        step = mesh.train_step_fn(ds5, cam5, film5, cfg5, lr=GRAD_LR,
                                  ops=wops)
        if name == "kernels":
            ops.reset_counts()
        new, loss = step(dict(p5), target5 * 0.8, idx5)
        torch.cuda.synchronize()
        if name == "kernels":
            launches = ops.counts()
        grads[name] = {k: (p5[k] - new[k]) / GRAD_LR for k in new}
        losses[name] = loss.item()
    grel = {k: ((grads["kernels"][k] - grads["plain"][k]).norm()
                / grads["plain"][k].norm().clamp(min=1e-30)).item()
            for k in p5}
    finite = all(torch.isfinite(g).all().item()
                 for gs in grads.values() for g in gs.values())
    _say(f"[8] train step 64x48 32spp depth 8: launches {launches}; loss "
         f"kernels {losses['kernels']:.6e} plain {losses['plain']:.6e}; "
         "grad rel " + ", ".join(f"{k} {v:.2e}" for k, v in grel.items())
         + "; grad norm " + ", ".join(
             f"{k} {v.norm().item():.4e}" for k, v in grads["kernels"].items())
         + f"; finite {finite}")
    if min(launches[k] for k in TRAIN_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if launches["hit_shade"] or launches["shade_split"]:
        raise AssertionError(f"the untextured step launched K5 / K6: "
                             f"{launches}")
    train_launches = launches
    if not finite or max(grel.values()) > GRAD_GATE:
        raise AssertionError("train step: kernel and plain gradients differ")
    if abs(losses["kernels"] - losses["plain"]) > 1e-4 * losses["plain"]:
        raise AssertionError("train step: losses differ")

    wave = 1 << 16
    n_waves = 256 * 256 * 16 // wave
    target = img_full.reshape(-1, 3)
    kd0 = torch.tensor(scene.materials.kd, device=dev) * 1.25
    plain_bwd = dataclasses.replace(integ.KERNEL_OPS,
                                    bounce_shade=plain_backward_shade())
    fb = {}
    for name, wops, reps in (("kernels", integ.KERNEL_OPS, 3),
                             ("plain backward", plain_bwd, 2)):
        step = mesh.train_step_fn(ds, camera, film_cfg, config, ops=wops)
        idx0 = torch.arange(wave, device=dev)
        kd, loss0 = step(kd0, target, idx0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, reps + 1):
            kd, _ = step(kd, target, (i % n_waves) * wave + idx0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _, loss1 = step(kd, target, idx0)
        fb[name] = dict(paths_per_s=reps * wave / dt, loss_before=loss0.item(),
                        loss_after=loss1.item(), steps=reps)
        if not fb[name]["loss_after"] < fb[name]["loss_before"]:
            raise AssertionError(f"{name}: the loss did not fall {fb[name]}")
    step = mesh.train_step_fn(ds, camera, film_cfg, config)
    torch.cuda.synchronize()
    with sphere_tests_refused():
        t0 = time.perf_counter()
        step(kd0, target, torch.arange(wave, device=dev))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    step_prof = wave_profile(
        lambda: step(kd0, target, torch.arange(wave, device=dev)))
    busy, nk, own = _busy_s(step_prof)
    # K4's calls in the step: one tape-kernel launch each
    k4_calls = sum(1 for e in step_prof.events()
                   if e.device_type.name == "CUDA"
                   and "bounce_shade_bwd_kernel" in e.name)
    k4_step_ms = 1e3 * own.get("bounce_shade_bwd", 0.0)
    _say(f"[8] fwd+bwd 256x256 16spp depth 8, waves of {wave}: "
         + "; ".join(f"{k} {v['paths_per_s']:.0f} paths/s ({v['steps']} "
                     f"steps), loss on wave 0 {v['loss_before']:.6e} -> "
                     f"{v['loss_after']:.6e}" for k, v in fb.items())
         + f"; one kernel-path step {1e3 * step_s:.1f} ms, device busy "
         f"{1e3 * busy:.1f} ms in {nk} launches (share "
         f"{busy / step_s:.2f}), of which "
         + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in own.items())
         + f"; K4 {k4_step_ms:.3f} ms on the card in {k4_calls} calls, "
         f"{k4_step_ms / max(k4_calls, 1):.3f} ms per call ({card})")

    # phase 9: K5 and K6 against their plain versions
    scene_t, atlas_t = fuzz.checker_textured(scene, dev)
    ds_t = sc.DeviceScene.build(scene_t, dev)
    tex_present = mats.tex_channel_presence(scene_t.materials)
    o_t, d_t, rxd, ryd = cam.generate_ray_differentials(
        camera, pxy + ws.film_jitter(), ws.u2(2))
    spread = torch.maximum((rxd - d_t).norm(dim=-1), (ryd - d_t).norm(dim=-1))
    carry_t = integ.initial_carry(o_t, d_t, ws.keys)
    carry_t["cone_w"] = torch.zeros_like(spread)
    carry_t["cone_g"] = spread / 4.0
    raw_t = integ.intersect_raw(ds_t, o_t, d_t, None, integ.PLAIN_OPS)

    xh0 = integ.pack_hit_input(carry_t, raw_t)
    hi0 = cb.unpack_hit_t(cb.cbody_hit_reference(xh0, ds_t.stab))
    res0 = mats.resolve_params(
        ds_t.mtab, hi0["mat_id"], hi0["ns"], hi0["ng"], hi0["dpdu"],
        uv=hi0["uv"], textures=atlas_t, dpdv=hi0["dpdv"],
        duvdx=hi0["duvdx"], duvdy=hi0["duvdy"], tex_present=tex_present)
    xs0 = integ.pack_shade_input(carry_t, raw_t, hi0, res0, lidx, selpdf,
                                 u_l, u_b, u_rr, 0)

    def fuzz_split(dsx, atlas, seed, hit=None):
        return fuzz.fuzz_split_inputs(
            dsx.ltab, dsx.mtab, dsx.stab, seed=seed, n=n, atlas=atlas,
            hit=hit, tex_present=mats.tex_channel_presence(dsx.materials))

    split_cases = [("first bounce", xh0, xs0, ds_t)]
    for nm, dsx, atlas in (("fuzz textured cornell", ds_t, atlas_t),
                           ("fuzz all-branches", ds2, None)):
        xh, xs, _ = fuzz_split(dsx, atlas, 5)
        split_cases.append((nm, xh, xs, dsx))

    def agree(a, b, flag_cols=()):
        both_nan = torch.isnan(a) & torch.isnan(b)
        close = torch.isclose(a, b, rtol=K3_RTOL, atol=K3_ATOL) | both_nan
        flags = min([1.0] + [(a[j] == b[j]).float().mean().item()
                             for j in flag_cols])
        exact = ((a == b) | both_nan).float().mean().item()
        err = (a - b).abs()[close].max().item()
        return close.float().mean().item(), flags, exact, err

    k56 = []
    k5_err = k6_err = 0.0
    for nm, xh, xs, dsx in split_cases:
        h_k = cb.hit_shade_t(xh, dsx.stab)
        h_p = cb.cbody_hit_reference(xh, dsx.stab)
        ids = torch.equal(h_k[24:26], h_p[24:26])
        c5, _, _, err5 = agree(h_k, h_p)
        sargs = (dsx.ltab, dsx.static, config.min_depth, config.rr_threshold)
        s_k = cb.shade_split_t(xs, *sargs)
        s_p = cb.cbody_shade_reference(xs, *sargs)
        c6, f6, _, err6 = agree(s_k, s_p, flag_cols)
        k5_err, k6_err = max(k5_err, err5), max(k6_err, err6)
        k56.append(dict(set=nm, k5_close=c5, k5_diff=bit_diff(h_k, h_p),
                        k5_ids=ids, k6_close=c6, k6_flags=f6,
                        k6_diff=bit_diff(s_k, s_p)))
        if c5 < K3_GATE or not ids or c6 < K3_GATE or f6 < K3_GATE \
                or k56[-1]["k5_diff"] or k56[-1]["k6_diff"]:
            raise AssertionError(f"K5 / K6 {nm}: {k56[-1]}")
    # K6 on a compacted mid-wave set: bounce 3 of the textured wave 0,
    # with its live count
    config_t = dataclasses.replace(config, textures=atlas_t)
    mid_t = fuzz.wave_shades(ds_t, camera, film_cfg, config_t,
                             integ.KERNEL_OPS)[3]
    sargs = (ds_t.ltab, ds_t.static, config.min_depth, config.rr_threshold)
    s_k = cb.shade_split_t(mid_t["xt"], *sargs, n_alive=mid_t["n_alive"])
    s_p = cb.cbody_shade_reference(mid_t["xt"], *sargs,
                                   n_alive=mid_t["n_alive"])
    c6, f6, _, err6 = agree(s_k, s_p, flag_cols)
    k6_err = max(k6_err, err6)
    k56.append(dict(set=f"textured wave 0 bounce 3 (live "
                    f"{int(mid_t['n_alive'])})", k6_close=c6, k6_flags=f6,
                    k6_diff=bit_diff(s_k, s_p),
                    k6_relaunch_diff=bit_diff(s_k, mid_t["out"])))
    if c6 < K3_GATE or f6 < K3_GATE or k56[-1]["k6_diff"] \
            or k56[-1]["k6_relaunch_diff"]:
        raise AssertionError(f"K6 {k56[-1]}")
    # the split against the fused kernel on untextured lanes
    _, xs2k, xf2 = fuzz_split(ds2, None, 5, hit=cb.hit_shade_t)
    split = cb.shade_split_t(xs2k, ds2.ltab, ds2.static, config.min_depth,
                             config.rr_threshold)
    fused = cb.bounce_shade_t(xf2, ds2.ltab, ds2.mtab, ds2.stab, ds2.static,
                              config.min_depth, config.rr_threshold)
    sf_close, sf_flags, sf_exact, _ = agree(split, fused, flag_cols)
    if sf_close < K3_GATE or sf_flags < K3_GATE:
        raise AssertionError(f"split vs fused: close {sf_close}, flags "
                             f"{sf_flags}")
    sargs0 = (ds_t.ltab, ds_t.static, config.min_depth, config.rr_threshold)
    # kernel times as every row's: CUDA events over back-to-back calls,
    # each on its own copy of the input, so that no call finds its input
    # in the L2 (each input alone fits there)
    k5_call = rotating(lambda x: ops.hit_shade(x, ds_t.stab), xh0)
    k6_call = rotating(lambda x: ops.shade_split(x, *sargs0), xs0)
    k5_ms, k6_ms = time_ms(k5_call), time_ms(k6_call)
    k5_plain = time_ms(lambda: cb.cbody_hit_reference(xh0, ds_t.stab),
                       iters=3)
    k6_plain = time_ms(lambda: cb.cbody_shade_reference(xs0, *sargs0),
                       iters=3)
    # and the kernels' own device time, from the profiler, on the same
    # rotated inputs (K3 on the same lanes for comparison)
    x0_t = integ.pack_bounce_input(carry_t, raw_t, lidx, selpdf, u_l, u_b,
                                   u_rr, 0)
    k5_dev, k5_q = kernel_ms(k5_call, "hit_shade_kernel")
    k6_dev, k6_q = kernel_ms(k6_call, "shade_split_kernel")
    k3_dev, k3_q = kernel_ms(rotating(lambda x: ops.bounce_shade(
        x, ds_t.ltab, ds_t.mtab, ds_t.stab, ds_t.static, config.min_depth,
        config.rr_threshold), x0_t), "bounce_shade_kernel")
    # operations: each half's plain version on the same inputs
    k5_ops = plain_ops(lambda: cb.cbody_hit_reference(xh0, ds_t.stab))
    k6_ops = plain_ops(lambda: cb.cbody_shade_reference(xs0, *sargs0))
    kern_rows["hit_shade"] = dict(
        max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain,
        bound=bound_ms(4 * n * (cb.HIT_IN_COLS + cb.HIT_OUT_COLS)
                       + 4 * ds_t.stab.numel(), k5_ops))
    kern_rows["shade_split"] = dict(
        max_abs_err=k6_err, ms=k6_ms, plain_ms=k6_plain,
        bound=bound_ms(4 * n * (cb.SHADE_IN_COLS + cb.OUT_COLS)
                       + 4 * ds_t.ltab.numel(), k6_ops))
    _say("[9] K5 / K6 (elements not equal to the bit) " + "; ".join(
        f"{r['set']}: " + (f"K5 close {r['k5_close']:.6f} not equal "
                           f"{r['k5_diff']} ids {r['k5_ids']}, "
                           if "k5_close" in r else "")
        + f"K6 close {r['k6_close']:.6f} flags {r['k6_flags']:.6f} not "
        f"equal {r['k6_diff']}" for r in k56)
        + f"; K5 -> lookups -> K6 vs K3 (fuzz all-branches): close "
        f"{sf_close:.6f}, flags {sf_flags:.6f}, bit-exact {sf_exact:.4f}; "
        f"first bounce, per launch by events: K5 {k5_ms:.4f} ms vs plain "
        f"{k5_plain:.3f} ms, K6 {k6_ms:.4f} ms vs plain {k6_plain:.3f} ms; "
        f"device time by the profiler: K5 {k5_dev:.4f} ms, K6 "
        f"{k6_dev:.4f} ms, K3 on the same lanes {k3_dev:.4f} ms; by queued events "
        f"K5 {k5_q:.4f} ms, K6 {k6_q:.4f} ms, K3 {k3_q:.4f} ms; plain "
        f"operations per lane K5 {k5_ops / n:.0f}, K6 {k6_ops / n:.0f}")

    # phase 10: the textured main path
    s10 = fuzz.checker_textured(s5, dev)
    ds10 = sc.DeviceScene.build(s10[0], dev)
    cfg10 = dataclasses.replace(cfg5, textures=s10[1])
    ops.reset_counts()
    img_tk = integ.render(ds10, cam5, film5, cfg10)
    torch.cuda.synchronize()
    tex_launches = ops.counts()
    img_tp = integ.render(ds10, cam5, film5, cfg10, ops=integ.PLAIN_OPS)
    dtex = float((img_tk - img_tp).abs().max().item())
    if not torch.isfinite(img_tk).all() or img_tk.shape != (48, 64, 3):
        raise AssertionError("textured render is not finite [48,64,3]")
    if min(tex_launches[k] for k in TEXTURED_KERNELS) < 1 \
            or tex_launches["bounce_shade"]:
        raise AssertionError(f"textured path launches: {tex_launches}")
    if dtex > PLAIN_ATOL:
        raise AssertionError(f"textured kernel and plain paths differ: "
                             f"{dtex}")
    if out_dir:
        np.save(os.path.join(out_dir, "cornell_textured_64x48_kernels.npy"),
                img_tk.cpu().numpy())
    tex_rates = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        integ.render(ds_t, camera, film_cfg,
                     dataclasses.replace(config_t, spp=1, sample_dx=1,
                                         sample_dy=1), ops=wops)
        torch.cuda.synchronize()
        with (sphere_tests_refused() if name == "kernels"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            img = integ.render(ds_t, camera, film_cfg, config_t, ops=wops)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if not torch.isfinite(img).all():
            raise AssertionError(f"textured {name} render not finite")
        tex_rates[name] = 256 * 256 * 16 / dt
    # one wave, textured and untextured: wall, device busy time, launches
    waves = {}
    for name, dsx, cfgx in (("textured", ds_t, config_t),
                            ("untextured", ds, config)):
        wave_args = (dsx, camera, cfgx, pxy, pid, sid, smp.make_base_key(0))
        with torch.no_grad():
            integ.trace_wave(*wave_args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            integ.trace_wave(*wave_args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof = wave_profile(lambda: integ.trace_wave(*wave_args))
        waves[name] = (wall,) + _busy_s(prof)
    wave_s, wbusy, wnk, wown = waves["textured"]
    uwave_s, ubusy, unk, _ = waves["untextured"]
    _say(f"[10] textured main path 64x48 32spp depth 8: launches "
         f"{tex_launches}; max |kernel - plain| {dtex:.3e} (gate "
         f"{PLAIN_ATOL}) | textured 256x256 16spp depth 8: kernels "
         f"{tex_rates['kernels']:.0f} paths/s, plain {tex_rates['plain']:.0f}"
         f" paths/s; textured / untextured (phase 6): kernels "
         f"{tex_rates['kernels'] / rates['kernels']:.3f}, plain "
         f"{tex_rates['plain'] / rates['plain']:.3f} | one textured wave "
         f"{1e3 * wave_s:.1f} ms, device busy {1e3 * wbusy:.1f} ms in {wnk} "
         f"launches (share {wbusy / wave_s:.2f}), of which "
         + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in wown.items())
         + f"; one untextured wave {1e3 * uwave_s:.1f} ms, device busy "
         f"{1e3 * ubusy:.1f} ms in {unk} launches (share "
         f"{ubusy / uwave_s:.2f}) ({card})")

    # phase 11: K8 and K9 against their plain versions
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    etex_json = os.path.join(REPO, "examples/cornellbox/cb_etex.json")
    s_e, _, _, cfg_e, _ = scenedesc.parse_scene(
        etex_json, spp_override=16, resolution_override=(256, 256))
    config_e = dataclasses.replace(config, textures=cfg_e.textures)
    ds_e = sc.DeviceScene.build(s_e, dev)
    atlas_e = cfg_e.textures.to(dev)
    hit_e = sc.intersect(ds_e, o_cam, d_cam)
    b_e = mats.compute_scattering(
        ds_e.materials, ds_e.mtab, hit_e.mat_id, hit_e.ns, hit_e.ng,
        hit_e.dpdu, uv=hit_e.uv, textures=atlas_e, dpdv=hit_e.dpdv)
    lidx_e, _ = nee.sample_one_light(ds_e, u_sel)
    wi_e = nee.light_sample(ds_e, lidx_e, hit_e.pos, u_l)["wi"]
    slot_cases = [("first bounce", b_e, -d_cam, u_b, wi_e, 31)]
    for nm, kw, types in (("fuzz recipes ALL", {}, 31),
                          ("fuzz recipes ALL_NON_SPECULAR", {}, 15),
                          ("fuzz grazing glass",
                           dict(grazing=True, rows=fuzz.SLOT_ROWS[3:4]), 31),
                          ("fuzz pruned matte",
                           dict(rows=fuzz.SLOT_ROWS[0:1]), 31)):
        bf, wof, uf, wif = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(n, 9, **kw),
                                           dev)
        slot_cases.append((nm, bf, wof, uf, wif, types))

    def close_share(a, b):
        both_nan = torch.isnan(a) & torch.isnan(b)
        close = torch.isclose(a, b, rtol=K3_RTOL, atol=K3_ATOL) | both_nan
        exact = ((a == b) | both_nan).float().mean().item()
        return close.float().mean().item(), exact, \
            (a - b).abs()[close].max().item()

    k89 = []
    k8_err = k9_err = ord_err = 0.0
    for nm, bx, wox, ux, wix, types in slot_cases:
        before = ops.SLOT_ORDER.launches
        got = ssh.bsdf_sample(bx, wox, ux, types)
        ref = sl.bsdf_sample(bx, wox, ux, types)
        kinds = (got[3] == ref[3]).float().mean().item()
        s8 = [close_share(got[j], ref[j]) for j in range(3)]
        got9 = ssh.bsdf_eval_pdf(bx, wox, wix, types)
        ref9 = sl.bsdf_eval_pdf(bx, wox, wix, types)
        s9 = [close_share(got9[j], ref9[j]) for j in range(2)]
        k8_err = max([k8_err] + [v[2] for v in s8])
        k9_err = max([k9_err] + [v[2] for v in s9])
        # one order for the BSDF's calls, equal to its plain twin; K8 in
        # the identity (wave) order gives the same bits
        orders = ops.SLOT_ORDER.launches - before
        oerr = order_err(bx)
        ord_err = max(ord_err, oerr)
        in_wave = ops.slot_sample(bx, wox, ux, types, torch.arange(
            bx.type.shape[0], dtype=torch.int32, device=dev))
        k89.append(dict(set=nm, types=types, k8_close=min(v[0] for v in s8),
                        k8_diff=sum(bit_diff(got[j], ref[j])
                                    for j in range(3)), k8_kinds=kinds,
                        k9_close=min(v[0] for v in s9),
                        k9_diff=sum(bit_diff(got9[j], ref9[j])
                                    for j in range(2)),
                        orders=orders, order_err=oerr,
                        wave_diff=sum(bit_diff(a.float(), b_.float())
                                      for a, b_ in zip(in_wave, got))))
        if min(k89[-1]["k8_close"], k89[-1]["k9_close"], kinds) < K3_GATE \
                or kinds < 1.0 or k89[-1]["k8_diff"] or k89[-1]["k9_diff"] \
                or orders != 1 or oerr or k89[-1]["wave_diff"]:
            raise AssertionError(f"K8 / K9 {nm}: {k89[-1]}")
    # the first bounce's calls, inputs rotated past the L2: the sweeps,
    # the order, the whole entry calls by the new and the earlier route
    t8 = slot_entry_times(b_e, -d_cam, u_b, 31, True)
    t9 = slot_entry_times(b_e, -d_cam, wi_e, 31, False)
    # the entries' launches: K8 in the recipe order, K9 in wave order
    k8_ms, k9_ms, ord_ms = t8["sweep"], t9["sweep"], t8["order"]
    k8_plain = time_ms(lambda: sl.bsdf_sample(b_e, -d_cam, u_b), iters=3)
    k9_plain = time_ms(lambda: sl.bsdf_eval_pdf(b_e, -d_cam, wi_e), iters=3)
    ord_plain = time_ms(lambda: ssh.lane_order_reference(b_e), iters=3)
    c8, c9 = slot_rotation(b_e, -d_cam, u_b), slot_rotation(b_e, -d_cam, wi_e)
    k8_dev, k8_q = kernel_ms(cycling(lambda bb, w, x: ops.slot_sample(
        bb, w, x, 31, ssh.lane_order(bb)), c8), "slot_sample_kernel")
    k9_dev, k9_q = kernel_ms(cycling(lambda bb, w, x: ops.slot_eval_pdf(
        bb, w, x, 31), c9), "slot_eval_pdf_kernel")
    ord_q = queued_ms(cycling(lambda bb, w, x: ops.slot_order(bb), c8))
    del c8, c9
    k8_ops = plain_ops(lambda: sl.bsdf_sample(b_e, -d_cam, u_b))
    k9_ops = plain_ops(lambda: sl.bsdf_eval_pdf(b_e, -d_cam, wi_e))
    ord_ops = plain_ops(lambda: ssh.lane_order_reference(b_e))
    # bytes: each field and per-lane input read once, each output written
    # once (the order's own bytes are the order's row: the types read,
    # the order written)
    kern_rows["slot_sample"] = dict(
        max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_plain,
        bound=bound_ms(4 * n * (ssh.SAMPLE_IN_COLS + ssh.SAMPLE_OUT_COLS),
                       k8_ops))
    kern_rows["slot_eval_pdf"] = dict(
        max_abs_err=k9_err, ms=k9_ms, plain_ms=k9_plain,
        bound=bound_ms(4 * n * (ssh.EVAL_IN_COLS + ssh.EVAL_OUT_COLS),
                       k9_ops))
    # its error: the largest |order - plain twin| over this phase's sets
    # (phase 16 adds BPT's BSDFs)
    kern_rows["slot_order"] = dict(
        max_abs_err=ord_err, ms=ord_ms, plain_ms=ord_plain,
        bound=bound_ms(4 * n * (sl.MAX_SLOTS + 1), ord_ops))
    fmt = lambda t: ", ".join(f"{k} {v:.4f}" for k, v in t.items())  # noqa
    _say("[11] K8 / K9 " + "; ".join(
        f"{r['set']} (types {r['types']}): K8 close {r['k8_close']:.6f} "
        f"not equal to the bit {r['k8_diff']} kinds {r['k8_kinds']:.6f}, "
        f"K9 close {r['k9_close']:.6f} not equal {r['k9_diff']}, orders "
        f"{r['orders']} max |order - plain twin| {r['order_err']}, K8 in "
        f"the identity order not equal {r['wave_diff']}"
        for r in k89)
        + f"; first bounce, ms per call by events (rotated): K8 {fmt(t8)}; "
        f"K9 {fmt(t9)}; plain K8 {k8_plain:.3f}, K9 {k9_plain:.3f}, order "
        f"{ord_plain:.3f} ms; device time of the entries' sweeps (K8 "
        f"ordered, K9 in wave order) by the profiler: K8 {k8_dev:.4f} ms, "
        f"K9 {k9_dev:.4f} ms; by queued "
        f"events K8 {k8_q:.4f} ms, K9 {k9_q:.4f} ms, the order {ord_q:.4f} "
        f"ms; plain operations per lane K8 {k8_ops / n:.0f}, K9 "
        f"{k9_ops / n:.0f}")

    # phase 12: the composed main path
    s12, cam12, film12, cfg12, _ = scenedesc.parse_scene(
        etex_json, spp_override=32, resolution_override=(64, 48))
    cfg12 = dataclasses.replace(cfg12, max_depth=8, wave_size=64 * 48 * 32)
    ds12 = sc.DeviceScene.build(s12, dev)
    ops.reset_counts()
    img_ck = integ.render(ds12, cam12, film12, cfg12)
    torch.cuda.synchronize()
    comp_launches = ops.counts()
    img_cp = integ.render(ds12, cam12, film12, cfg12, ops=integ.PLAIN_OPS)
    dcomp = float((img_ck - img_cp).abs().max().item())
    if not torch.isfinite(img_ck).all() or img_ck.shape != (48, 64, 3) \
            or not img_ck.max() > 0.0:
        raise AssertionError("composed render is not finite [48,64,3]")
    if min(comp_launches[k] for k in COMPOSED_KERNELS) < 1 or any(
            comp_launches[k] for k in ("bounce_shade", "hit_shade",
                                       "shade_split")):
        raise AssertionError(f"composed path launches: {comp_launches}")
    if dcomp > PLAIN_ATOL:
        raise AssertionError(f"composed kernel and plain paths differ: "
                             f"{dcomp}")
    img_forced = integ.render(ds5, cam5, film5, cfg5, composed=True)
    dforced = float(np.abs(img_forced.cpu().numpy() - img_k).max())
    if dforced > FUSED_ATOL:
        raise AssertionError(f"cb.json composed vs fused: {dforced}")
    if out_dir:
        np.save(os.path.join(out_dir, "cornell_etex_64x48_kernels.npy"),
                img_ck.cpu().numpy())
    comp_rates = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        integ.render(ds_e, camera, film_cfg,
                     dataclasses.replace(config_e, spp=1, sample_dx=1,
                                         sample_dy=1), ops=wops)
        torch.cuda.synchronize()
        with (sphere_tests_refused(local=False) if name == "kernels"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            img = integ.render(ds_e, camera, film_cfg, config_e, ops=wops)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if not torch.isfinite(img).all():
            raise AssertionError(f"composed {name} render not finite")
        comp_rates[name] = 256 * 256 * 16 / dt
    wave_args = (ds_e, camera, config_e, pxy, pid, sid, smp.make_base_key(0))
    with torch.no_grad():
        integ.trace_wave(*wave_args)
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        integ.trace_wave(*wave_args)
        torch.cuda.synchronize()
        cwave_s = time.perf_counter() - t0
        wave_launches = ops.counts()
        prof = wave_profile(lambda: integ.trace_wave(*wave_args))
        cslots = slot_wave_ms(prof)
    cbusy, cnk, cown = _busy_s(prof)
    _say(f"[12] composed main path (cb_etex.json) 64x48 32spp depth 8: "
         f"launches {comp_launches}; max |kernel - plain| {dcomp:.3e} (gate "
         f"{PLAIN_ATOL}); cb.json composed vs fused max |diff| {dforced:.3e} "
         f"(gate {FUSED_ATOL}) | composed 256x256 16spp depth 8: kernels "
         f"{comp_rates['kernels']:.0f} paths/s, plain "
         f"{comp_rates['plain']:.0f} paths/s; composed / fused (phase 6): "
         f"kernels {comp_rates['kernels'] / rates['kernels']:.3f}, plain "
         f"{comp_rates['plain'] / rates['plain']:.3f} | one composed wave "
         f"{1e3 * cwave_s:.1f} ms, kernel launches {wave_launches}, device "
         f"busy {1e3 * cbusy:.1f} ms in {cnk} launches (share "
         f"{cbusy / cwave_s:.2f}), of which "
         + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in cown.items())
         + "; (launches, device ms) of " + slot_wave_text(cslots)
         + f" ({card})")

    # phase 13: K3 on tables of more than 32 rows (K7's function)
    ds_w = sc.DeviceScene.build(fuzz.spread_materials(scene), dev)
    if ds_w.mtab.shape[0] <= 32:
        raise AssertionError("the wide tables have 32 rows or fewer")
    raw_w = integ.intersect_raw(ds_w, o_cam, d_cam, None, integ.PLAIN_OPS)
    x0_w = integ.pack_bounce_input(carry, raw_w, lidx, selpdf, u_l, u_b,
                                   u_rr, 0)
    wargs = (ds_w.ltab, ds_w.mtab, ds_w.stab, ds_w.static, config.min_depth,
             config.rr_threshold)
    xf_w = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.cpu().numpy() for t in wargs[:3]), seed=2, n=n).T.copy(),
        device=dev)
    k7 = []
    k7_err = 0.0
    mid_w = fuzz.wave_shades(ds_w, camera, film_cfg, config,
                             integ.KERNEL_OPS)[3]
    for nm, xt, na in (("first bounce", x0_w, None), ("fuzz", xf_w, None),
                       (f"wave 0 bounce 3 (live {int(mid_w['n_alive'])})",
                        mid_w["xt"], mid_w["n_alive"])):
        out_k = cb.bounce_shade_t(xt, *wargs, n_alive=na)
        out_p = cb.cbody_reference(xt, *wargs, n_alive=na)
        fr, _, err = close_share(out_k, out_p)
        flags = min((out_k[j] == out_p[j]).float().mean().item()
                    for j in flag_cols)
        k7_err = max(k7_err, err)
        k7.append((nm, fr, flags, bit_diff(out_k, out_p)))
        if fr < K3_GATE or flags < K3_GATE or k7[-1][3]:
            raise AssertionError(f"K3 on wide tables, {nm}: {k7[-1]}")
    k7_call = rotating(lambda x: ops.bounce_shade(x, *wargs), x0_w)
    k7_ms = time_ms(k7_call)
    k7_dev, k7_q = kernel_ms(k7_call, "bounce_shade_kernel")
    k7_plain = time_ms(lambda: cb.cbody_reference(x0_w, *wargs), iters=3)
    k7_ops = plain_ops(lambda: cb.cbody_reference(x0_w, *wargs))
    kern_rows["bounce_shade_wide"] = dict(
        max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain,
        bound=bound_ms(4 * n * (cb.IN_COLS + cb.OUT_COLS) + 4 * sum(
            t.numel() for t in wargs[:3]), k7_ops))
    ds5_w = sc.DeviceScene.build(fuzz.spread_materials(s5), dev)
    ops.reset_counts()
    img_w = integ.render(ds5_w, cam5, film5, cfg5)
    torch.cuda.synchronize()
    wide_launches = ops.counts()
    dwide = float(np.abs(img_w.cpu().numpy() - img_k).max())
    if wide_launches["bounce_shade"] < 1 or dwide > 0.0:
        raise AssertionError(f"wide tables: launches {wide_launches}, "
                             f"max |wide - narrow| {dwide}")
    _say(f"[13] K3 on {ds_w.mtab.shape[0]}-row material tables: " + "; ".join(
        f"{nm}: close {fr:.6f}, flags {fl:.6f}, elements not equal to the "
        f"bit {df}" for nm, fr, fl, df in k7) + f"; first bounce {k7_ms:.4f} ms by "
        f"events (device {k7_dev:.4f} ms, queued {k7_q:.4f} ms) vs plain {k7_plain:.3f} ms; "
        f"64x48 32spp depth 8 render: launches {wide_launches}, max |wide - "
        f"9-row| {dwide:.3e}")

    # phase 14: the sphere branch of K1 / K2
    from arendur_tpu_torch.shapes import sphere as sph
    na14 = torch.tensor(n - 9000, device=dev)
    live14 = torch.arange(n, device=dev) < n - 9000
    k14 = []
    k14_err = 0.0
    # and cb.json with 2,249 small spheres more: a table of 2,251 rows,
    # past the 2,250 K1 / K2 once held whole (five chunks now)
    big14, *_ = scenedesc.parse_scene(big_tables.write(
        os.path.join(scratch, "cb_2251.json"),
        big_tables.lights_desc(spheres=2249)))
    for nm, scene_x, dsx in (("cb.json", scene, ds),
                             ("all-branches", b2, ds2),
                             ("2,251 spheres", big14,
                              sc.DeviceScene.build(big14, dev))):
        v = np.concatenate([scene_x.tri_v0, scene_x.tri_v1, scene_x.tri_v2])
        o14, d14, tm14 = (torch.tensor(a, device=dev) for a in
                          fuzz.sphere_rays(scene_x.spheres, v.min(0),
                                           v.max(0), n, 14))
        for full_phi in (False, True):
            kw = dict(sph_tab=dsx.ktab, full_phi=full_phi)
            args = (dsx.cw, dsx.cbox, o14, d14, tm14, na14)
            t_k, s_k = ci.intersect_clusters(*args, **kw)
            t_p, s_p = ci.intersect_clusters_reference(*args, **kw)
            b_k = ci.occluded_clusters(*args, **kw)
            b_p = ci.occluded_clusters_reference(*args, **kw)
            fr, split, tie, err, t_eq = sphere_agreement(t_k, s_k, t_p, s_p,
                                                         live14)
            bfr = ((b_k == b_p) & live14).sum().item() / (n - 9000)
            dead = bool((s_k[~live14] == -1).all()
                        and not b_k[~live14].any())
            k14_err = max(k14_err, err)
            k14.append(dict(scene=nm, full_phi=full_phi, codes_agree=fr,
                            sphere_splits=split, sphere_ties=tie,
                            sphere_t_equal=t_eq, blocked_agree=bfr,
                            dead_lanes_miss=dead,
                            sphere_lanes=int(((s_k <= -2) & live14).sum()),
                            blocked=b_k[live14].float().mean().item()))
            if split > tie or not t_eq or not dead or fr < K1_K2_GATE \
                    or bfr < K1_K2_GATE:
                raise AssertionError(f"K1 / K2 sphere branch: {k14[-1]}")
    # the tie set: every lane against the plain version, the winners
    w_ts, cbox_ts, ktab_ts, o_ts, d_ts, tm_ts, na_ts, want_ts, want_nts = \
        fuzz.tie_set()
    on = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    n_ts = o_ts.shape[0]
    crafted = torch.tensor([x is not None for x in want_ts], device=dev)
    tie = {}
    for nm, args, kw, want in (
            ("spheres", (on(w_ts), on(cbox_ts), on(o_ts), on(d_ts),
                         on(tm_ts), torch.tensor(na_ts, device=dev)),
             dict(sph_tab=on(ktab_ts)), want_ts),
            ("no table", (on(w_ts), on(cbox_ts), on(o_ts), on(d_ts),
                          on(tm_ts), torch.tensor(na_ts, device=dev)),
             {}, want_nts),
            ("period", (on(w_ts), on(cbox_ts),
                        *(on(np.concatenate([x, x]))
                          for x in (o_ts, d_ts, tm_ts)),
                        torch.tensor(na_ts, device=dev)),
             dict(period=n_ts), want_nts + want_nts)):
        t_k, s_k = ci.intersect_clusters(*args, **kw)
        t_p, s_p = ci.intersect_clusters_reference(*args, **kw)
        b_k = ci.occluded_clusters(*args, **kw)
        b_p = ci.occluded_clusters_reference(*args, **kw)
        exact = crafted.repeat(s_k.shape[0] // n_ts)
        winners = [int(s_k[i]) == x for i, x in enumerate(want)
                   if x is not None]
        tie[nm] = dict(
            slots_equal=bool(torch.equal(s_k, s_p)),
            blocked_equal=bool(torch.equal(b_k, b_p)),
            t_equal_crafted=bool(torch.equal(t_k[exact], t_p[exact])),
            t_close=bool(torch.allclose(t_k, t_p, rtol=T_RTOL)),
            winners=sum(winners), cases=len(winners))
        if not all(v for k, v in tie[nm].items() if k != "cases") \
                or not all(winners):
            raise AssertionError(f"K1 / K2 tie set, {nm}: {tie[nm]}")
    # times on the main path's inputs: the camera wave and its shadow
    # rays against cb.json's spheres
    skw = dict(sph_tab=ds.ktab, full_phi=ds.full_phi)
    od_cam = torch.stack([o_cam, d_cam])
    k1s_call = rotating(lambda x: ops.closest_hit(
        ds.cw, ds.cbox, x[0], x[1], tinf, **skw), od_cam)
    k1n_call = rotating(lambda x: ops.closest_hit(
        ds.cw, ds.cbox, x[0], x[1], tinf), od_cam)
    sh_od = torch.stack([sh[0], sh[1]])
    k2s_call = rotating(lambda x: ops.any_hit(
        ds.cw, ds.cbox, x[0], x[1], sh[2], **skw), sh_od)
    k2n_call = rotating(lambda x: ops.any_hit(
        ds.cw, ds.cbox, x[0], x[1], sh[2]), sh_od)
    k1s_ms, k1n_ms = time_ms(k1s_call), time_ms(k1n_call)
    k2s_ms, k2n_ms = time_ms(k2s_call), time_ms(k2n_call)
    k1s_plain = time_ms(lambda: ci.intersect_clusters_reference(
        ds.cw, ds.cbox, o_cam, d_cam, tinf, **skw), iters=3)
    k2s_plain = time_ms(lambda: ci.occluded_clusters_reference(
        ds.cw, ds.cbox, *sh, **skw), iters=3)
    k1s_dev, k1s_q = kernel_ms(k1s_call, "cluster_kernel")
    k1n_dev, k1n_q = kernel_ms(k1n_call, "cluster_kernel")
    k2s_dev, k2s_q = kernel_ms(k2s_call, "cluster_kernel")
    k2n_dev, k2n_q = kernel_ms(k2n_call, "cluster_kernel")
    t_k, s_k = ops.closest_hit(ds.cw, ds.cbox, o_cam, d_cam, tinf, **skw)
    t_p, s_p = ci.intersect_clusters_reference(ds.cw, ds.cbox, o_cam, d_cam,
                                               tinf, **skw)
    b_k = ops.any_hit(ds.cw, ds.cbox, *sh, **skw)
    b_p = ci.occluded_clusters_reference(ds.cw, ds.cbox, *sh, **skw)
    all_live = torch.ones(n, dtype=torch.bool, device=dev)
    cam_agree = sphere_agreement(t_k, s_k, t_p, s_p, all_live)
    sh_agree = (b_k == b_p).float().mean().item()
    if cam_agree[1] > cam_agree[2] or not cam_agree[4] \
            or cam_agree[0] < K1_K2_GATE or sh_agree < K1_K2_GATE:
        raise AssertionError(f"K1 / K2 with spheres on the main path's "
                             f"inputs: {cam_agree}, {sh_agree}")
    # the clusters the rays enter before their bound (K2: up to each
    # ray's first occluder, on the rays no sphere blocks), and the plain
    # sphere branch's operations on the same rays
    sph_bytes = 4 * ds.ktab.numel()
    # the sphere branch alone: its operations on the same rays and the
    # table it reads (the bound of PERF.md's "K1 / K2 branch" row)
    sph1_ops = sphere_ops(ds.ktab, o_cam, d_cam, tinf, ds.full_phi)
    sph2_ops = sphere_ops(ds.ktab, *sh, ds.full_phi)
    branch_bound = [bound_ms(sph_bytes, v) for v in (sph1_ops, sph2_ops)]
    k1s_wb, k1s_ops = closest_work(ds.cw, ds.cbox, o_cam, d_cam, t_k)
    k1s_ops += sph1_ops
    blk_s = sph.sphere_best(ds.ktab, *sh, ds.full_phi)[1] != -1
    k2s_wb, k2s_ops = any_work(ds.cw, ds.cbox, sh[0][~blk_s], sh[1][~blk_s],
                               sh[2][~blk_s])
    k2s_ops += sph2_ops
    kern_rows["closest_hit_spheres"] = dict(
        max_abs_err=max(k14_err, cam_agree[3]), ms=k1s_ms,
        plain_ms=k1s_plain, bound=bound_ms(k1_io + k1s_wb + sph_bytes, k1s_ops))
    kern_rows["any_hit_spheres"] = dict(
        max_abs_err=float(sh_agree < 1.0), ms=k2s_ms, plain_ms=k2s_plain,
        bound=bound_ms(k2_io + k2s_wb + sph_bytes, k2s_ops))
    k14_times = dict(k1_ms=[k1s_ms, k1n_ms], k2_ms=[k2s_ms, k2n_ms],
                     k1_device_ms=[k1s_dev, k1n_dev],
                     k1_queued_ms=[k1s_q, k1n_q],
                     k2_device_ms=[k2s_dev, k2n_dev],
                     k2_queued_ms=[k2s_q, k2n_q],
                     plain_ms=[k1s_plain, k2s_plain],
                     cam_agree=cam_agree, shadow_agree=sh_agree,
                     ops=[k1s_ops, k2s_ops], branch_ops=[sph1_ops, sph2_ops],
                     branch_bound_ms=[b[0] for b in branch_bound])
    _say("[14] K1 / K2 sphere branch " + "; ".join(
        f"{r['scene']} full_phi {r['full_phi']}: codes agree "
        f"{r['codes_agree']:.6f} ({r['sphere_lanes']} sphere lanes, "
        f"{r['sphere_splits']} sphere splits of which {r['sphere_ties']} "
        f"ties), sphere t equal {r['sphere_t_equal']}, blocked agree "
        f"{r['blocked_agree']:.6f} (blocked {r['blocked']:.3f}), dead "
        f"lanes miss {r['dead_lanes_miss']}" for r in k14)
        + f" | camera wave (cb.json, {ds.ktab.shape[0]} spheres, full_phi "
        f"{ds.full_phi}): codes agree {cam_agree[0]:.6f}, shadow rays "
        f"agree {sh_agree:.6f}; per launch by events K1 {k1s_ms:.4f} ms "
        f"with the sphere table vs {k1n_ms:.4f} ms without, K2 "
        f"{k2s_ms:.4f} vs {k2n_ms:.4f} ms; device (profiler / queued) K1 "
        f"{k1s_dev:.4f} / {k1s_q:.4f} ms vs {k1n_dev:.4f} / {k1n_q:.4f} "
        f"ms, K2 {k2s_dev:.4f} / {k2s_q:.4f} ms vs {k2n_dev:.4f} / "
        f"{k2n_q:.4f} ms; plain K1 {k1s_plain:.3f} ms, K2 "
        f"{k2s_plain:.3f} ms; the sphere branch alone: bound K1 "
        f"{branch_bound[0][0]:.4f} ms, K2 {branch_bound[1][0]:.4f} ms "
        f"({branch_bound[0][1]}) | tie set ("
        f"{n_ts} rays): " + "; ".join(
            f"{k}: slots equal {v['slots_equal']}, blocked equal "
            f"{v['blocked_equal']}, t equal on the crafted rays "
            f"{v['t_equal_crafted']}, winners {v['winners']} of {v['cases']}"
            for k, v in tie.items()))

    # phase 15: instanced meshes, cb_inst.json (the Cornell box placed
    # 100 times, 200 spheres, no world triangle)
    inst_json = os.path.join(REPO, "examples/cornellbox/cb_inst.json")
    s_i, cam_i, film_i, cfg_i, _ = scenedesc.parse_scene(
        inst_json, spp_override=16, resolution_override=(256, 256))
    cfg_i = dataclasses.replace(cfg_i, max_depth=8, wave_size=1 << 16)
    ds_i = sc.DeviceScene.build(s_i, dev)
    im = ds_i.inst[0]
    n_inst = im.n_instances
    if ds_i.cw.shape[0] or ds_i.n_tris or len(ds_i.inst) != 1 \
            or ds_i.composed_only:
        raise AssertionError("cb_inst.json is not a pure-instanced scene")
    # a ray set of 4,096 camera rays over the whole frame (every 16th
    # pixel, sample 0), its first bounce's continuation rays (with a live
    # count) and its shadow rays
    n4 = 4096
    pid4 = torch.arange(n4, device=dev) * 16
    sid4 = torch.zeros_like(pid4)
    pxy4 = torch.stack([(pid4 % 256).float(), (pid4 // 256).float()], -1)
    ws4 = smp.WaveSampler(smp.make_base_key(0), pid4, sid4, sample_dx=4,
                          sample_dy=4)
    o4, d4 = cam.generate_rays(cam_i, pxy4 + ws4.film_jitter(), ws4.u2(2))

    def first_bounce(o_, d_, keys):
        """The first fused bounce's output on the kernel path."""
        raw_ = integ.intersect_raw(ds_i, o_, d_, None, integ.KERNEL_OPS)
        u_s, u_l_, u_b_, u_r = integ.bounce_draws(cfg_i, keys, 0)
        li_, sp_ = nee.sample_one_light(ds_i, u_s)
        x_ = integ.pack_bounce_input(integ.initial_carry(o_, d_, keys), raw_,
                                     li_, sp_, u_l_, u_b_, u_r, 0)
        return cb.unpack_out_t(cb.bounce_shade_t(
            x_, ds_i.ltab, ds_i.mtab, ds_i.stab, ds_i.static,
            cfg_i.min_depth, cfg_i.rr_threshold))

    r4 = first_bounce(o4, d4, ws4.keys)
    t4 = torch.full((n4,), float("inf"), device=dev)
    na4 = torch.tensor(n4 - 500, device=dev)
    skw = dict(sph_tab=ds_i.ktab, full_phi=ds_i.full_phi)
    k15 = []
    for nm, o_, d_, tm_, na in (
            ("camera", o4, d4, t4, None),
            ("bounce 1", r4["o"].contiguous(), r4["d"].contiguous(), t4, na4),
            ("shadow", r4["sh_o"].contiguous(), r4["sh_d"].contiguous(),
             r4["sh_t"].contiguous(), None)):
        # the world K1 / K2 with no cluster: the sphere table alone,
        # equal to the plain versions on every lane, no descriptor
        enc = ops.isect_encodes()
        wa = (ds_i.cw, ds_i.cbox, o_, d_, tm_, na)
        t_k, s_k = ci.intersect_clusters(*wa, **skw)
        b_k = ci.occluded_clusters(*wa, **skw)
        no_encode = ops.isect_encodes() == enc
        t_p, s_p = ci.intersect_clusters_reference(*wa, **skw)
        b_p = ci.occluded_clusters_reference(*wa, **skw)
        world_equal = bool(torch.equal(s_k, s_p) and torch.equal(t_k, t_p)
                           and torch.equal(b_k, b_p))
        # the instanced entries (the world rays against the 100
        # instances, the any hit from the world's flags) against their
        # plain versions, every lane to the bit
        ti_k, si_k, ii_k = ci.intersect_instanced(
            im.cw, im.cbox, im.itab, o_, d_, tm_, na)
        bi_k = ci.occluded_instanced(im.cw, im.cbox, im.itab, o_, d_, tm_,
                                     na, b_k)
        ti_p, si_p, ii_p = ci.intersect_instanced_reference(
            im.cw, im.cbox, im.itab, o_, d_, tm_, na)
        bi_p = ci.occluded_instanced_reference(im.cw, im.cbox, im.itab, o_,
                                               d_, tm_, na, b_p)
        new_equal = bool(torch.equal(ti_k, ti_p) and torch.equal(si_k, si_p)
                         and torch.equal(ii_k, ii_p)
                         and torch.equal(bi_k, bi_p))
        # the earlier [I * N]-lane launches (period 4,096) against their
        # plain versions, and their nearest instance against the new
        # entries' (torch.argmin's first minimum), every lane
        ol, dl = sc.instance_rays(im, o_, d_)
        ia = (im.cw, im.cbox, ol, dl, tm_.repeat(n_inst), na)
        to_k, so_k = ci.intersect_clusters(*ia, period=n4)
        bo_k = ci.occluded_clusters(*ia, period=n4)
        to_p, so_p = ci.intersect_clusters_reference(*ia, period=n4)
        bo_p = ci.occluded_clusters_reference(*ia, period=n4)
        t_im = torch.where(so_k >= 0, to_k, float("inf")).reshape(n_inst, n4)
        first = torch.argmin(t_im, 0)
        s_old = so_k.reshape(n_inst, n4).gather(0, first[None])[0]
        old_equal = bool(
            torch.equal(so_k, so_p) and torch.equal(to_k, to_p)
            and torch.equal(bo_k, bo_p) and torch.equal(s_old, si_k)
            and torch.equal(first.int(), ii_k)
            and torch.equal(bo_k.reshape(n_inst, n4).any(0) | b_k, bi_k))
        live = torch.ones(n4, dtype=torch.bool, device=dev) \
            if na is None else torch.arange(n4, device=dev) < int(na)
        dead_ok = bool((si_k[~live] == -1).all() and (ii_k[~live] == 0).all()
                       and not bi_k[~live].any())
        # the whole query, the kernels' against the plain versions'
        c_k = sc.closest_hits(ds_i, o_, d_, tm_, na, ci.intersect_clusters,
                              ci.intersect_instanced)
        c_p = sc.closest_hits(ds_i, o_, d_, tm_, na,
                              ci.intersect_clusters_reference,
                              ci.intersect_instanced_reference)
        q_hit = (c_k.hit == c_p.hit).float().mean().item()
        k15.append(dict(set=nm, world_equal=world_equal,
                        no_encode=no_encode, instanced_equal=new_equal,
                        period_equal=old_equal, dead_lanes_miss=dead_ok,
                        inst_hit=(si_k >= 0).float().mean().item(),
                        inst_blocked=bi_k.float().mean().item(),
                        sphere_lanes=int((s_k <= -2).sum()),
                        query_hit_agree=q_hit))
        if not (world_equal and no_encode and new_equal and old_equal
                and dead_ok) or q_hit < K1_K2_GATE:
            raise AssertionError(f"K1 / K2 on cb_inst, {nm}: {k15[-1]}")

    # the cb_inst render at 64x48, 4 spp, depth 8 (waves of 4,096: each
    # instanced query 409,600 lanes), kernels against the plain path
    s15, cam15, film15, cfg15, _ = scenedesc.parse_scene(
        inst_json, spp_override=4, resolution_override=(64, 48))
    cfg15 = dataclasses.replace(cfg15, max_depth=8, wave_size=n4)
    ds15 = sc.DeviceScene.build(s15, dev)
    ops.reset_counts()
    img_ik = integ.render(ds15, cam15, film15, cfg15)
    torch.cuda.synchronize()
    inst_launches = ops.counts()
    img_ip = integ.render(ds15, cam15, film15, cfg15, ops=integ.PLAIN_OPS)
    dinst = float((img_ik - img_ip).abs().max().item())
    if not torch.isfinite(img_ik).all() or img_ik.shape != (48, 64, 3) \
            or not img_ik.max() > 0.0:
        raise AssertionError("cb_inst render is not finite [48,64,3]")
    if min(inst_launches[k] for k in INSTANCED_KERNELS) < 1 or any(
            inst_launches[k] for k in ("hit_shade", "shade_split",
                                       "slot_sample", "slot_eval_pdf")):
        raise AssertionError(f"cb_inst path launches: {inst_launches}")
    if dinst > PLAIN_ATOL:
        raise AssertionError(f"cb_inst kernel and plain paths differ: "
                             f"{dinst}")
    if out_dir:
        np.save(os.path.join(out_dir, "cb_inst_64x48_kernels.npy"),
                img_ik.cpu().numpy())
    # one train step at 64x48 on the whole frame (12,288 paths in one
    # wave: on part of the frame the Lanczos filter leaves pixels of
    # near-zero weight at its edge, whose loss ulps decide the gradient),
    # kernels against plain
    n15 = 64 * 48 * 4
    cfg15s = dataclasses.replace(cfg15, wave_size=n15)
    m15 = ds15.materials
    p15 = {k: torch.tensor(v, device=dev) for k, v in
           (("kd", m15.kd), ("ks", m15.ks), ("roughness", m15.roughness))}
    grads15, losses15 = {}, {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        step = mesh.train_step_fn(ds15, cam15, film15, cfg15s, lr=GRAD_LR,
                                  ops=wops)
        if name == "kernels":
            ops.reset_counts()
        new, loss = step(dict(p15), img_ik.reshape(-1, 3) * 0.8,
                         torch.arange(n15, device=dev))
        torch.cuda.synchronize()
        if name == "kernels":
            step15_launches = ops.counts()
        grads15[name] = {k: (p15[k] - new[k]) / GRAD_LR for k in new}
        losses15[name] = loss.item()
    grel15 = {k: ((grads15["kernels"][k] - grads15["plain"][k]).norm()
                  / grads15["plain"][k].norm().clamp(min=1e-30)).item()
              for k in p15}
    finite15 = all(torch.isfinite(g).all().item()
                   for gs in grads15.values() for g in gs.values())
    if not finite15 or max(grel15.values()) > GRAD_GATE \
            or min(step15_launches[k] for k in INSTANCED_KERNELS
                   + ("bounce_shade_bwd",)) < 1:
        raise AssertionError(f"cb_inst train step: grad rel {grel15}, "
                             f"finite {finite15}, {step15_launches}")

    # the full-width render: paths/s with no sphere test outside K1 / K2,
    # then one wave's launches, device busy time by kernel, TMA encodes,
    # batched products (the frame transforms the instanced kernels took
    # over: none) and peak device memory
    integ.render(ds_i, cam_i, film_i, dataclasses.replace(
        cfg_i, spp=1, sample_dx=1, sample_dy=1))
    torch.cuda.synchronize()
    with sphere_tests_refused():
        t0 = time.perf_counter()
        img_if = integ.render(ds_i, cam_i, film_i, cfg_i)
        torch.cuda.synchronize()
        dt_i = time.perf_counter() - t0
    if not torch.isfinite(img_if).all():
        raise AssertionError("cb_inst 256x256 render not finite")
    inst_rate = 256 * 256 * 16 / dt_i
    wave_i = (ds_i, cam_i, cfg_i, pxy, pid, sid, smp.make_base_key(0))
    with torch.no_grad():
        integ.trace_wave(*wave_i)
        torch.cuda.synchronize()
        ops.reset_counts()
        enc0 = ops.isect_encodes()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        integ.trace_wave(*wave_i)
        torch.cuda.synchronize()
        iwave_s = time.perf_counter() - t0
        iwave_mem = torch.cuda.max_memory_allocated() - mem0
        iwave_launches = ops.counts()
        iwave_encodes = ops.isect_encodes() - enc0
        iprof = wave_profile(lambda: integ.trace_wave(*wave_i))
    ibusy, ink, iown = _busy_s(iprof)
    ibmm = batched_products(iprof)
    if ibmm:
        raise AssertionError(f"a cb_inst wave ran {ibmm} batched products")
    # a world pool and instances together (cb.json's box and spheres
    # beside cb_inst's instanced mesh): the descriptor cache holds both
    # weights, so a wave after the first encodes none
    ds_mix = sc.DeviceScene.build(dataclasses.replace(scene, inst=s_i.inst),
                                  dev)
    wave_mix = (ds_mix, camera, config, pxy, pid, sid, smp.make_base_key(0))
    with torch.no_grad():
        enc0 = ops.isect_encodes()
        integ.trace_wave(*wave_mix)
        mix_first = ops.isect_encodes() - enc0
        enc0 = ops.isect_encodes()
        ops.reset_counts()
        integ.trace_wave(*wave_mix)
        torch.cuda.synchronize()
        mix_encodes = ops.isect_encodes() - enc0
        mix_launches = ops.counts()
    if iwave_encodes or mix_encodes:
        raise AssertionError(f"TMA descriptors re-encoded in a wave: "
                             f"cb_inst {iwave_encodes}, mixed {mix_encodes}")
    # the instanced K1 / K2 per query on the main path's inputs: wave 0's
    # camera rays against the 100 instances, and the shadow rays of its
    # first bounce from the world K2's flags; every lane equal to the
    # plain versions; beside them, in the same run, the earlier route on
    # the same query (the rays into the 100 frames, one launch over the
    # 6.55 M (instance, ray) lanes with period N, the nearest instance)
    o_w0, d_w0 = cam.generate_rays(cam_i, pxy + ws.film_jitter(), ws.u2(2))
    r_w0 = first_bounce(o_w0, d_w0, ws.keys)
    sh_w0 = tuple(r_w0[k].contiguous() for k in ("sh_o", "sh_d", "sh_t"))
    b_w0 = ci.occluded_clusters(ds_i.cw, ds_i.cbox, *sh_w0,
                                sph_tab=ds_i.ktab, full_phi=ds_i.full_phi)
    iq = {}
    for kind, o_, d_, tm_, blk in (("closest", o_w0, d_w0, tinf, None),
                                   ("any",) + sh_w0 + (b_w0,)):
        closest = kind == "closest"
        args = (im.cw, im.cbox, im.itab, o_, d_, tm_, None)
        ol, dl = sc.instance_rays(im, o_, d_)
        tb = tm_.repeat(n_inst)
        if closest:
            call = lambda: ops.closest_hit_instanced(*args)  # noqa: E731
            plain = lambda: ci.intersect_instanced_reference(*args)  # noqa
            period = lambda: ops.closest_hit(  # noqa: E731
                im.cw, im.cbox, ol, dl, tb, None, n)
        else:
            call = lambda: ops.any_hit_instanced(*args, blk)  # noqa: E731
            plain = lambda: ci.occluded_instanced_reference(  # noqa: E731
                *args, blk)
            period = lambda: ops.any_hit(  # noqa: E731
                im.cw, im.cbox, ol, dl, tb, None, n)
        got, ref = results(call()), results(plain())
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"instanced {kind} on wave 0 differs from "
                                 f"its plain version")

        def old_query():
            """The earlier route, whole: the [I * N] local rays, the
            period launch, the nearest instance (or the OR)."""
            ol_, dl_ = sc.instance_rays(im, o_, d_)
            if not closest:
                return ops.any_hit(im.cw, im.cbox, ol_, dl_,
                                   tm_.repeat(n_inst), None,
                                   n).reshape(n_inst, n).any(0) | blk
            t_f, s_f = ops.closest_hit(im.cw, im.cbox, ol_, dl_,
                                       tm_.repeat(n_inst), None, n)
            t_im = torch.where(s_f >= 0, t_f, float("inf")).reshape(n_inst,
                                                                    n)
            first = torch.argmin(t_im, 0)
            return (t_im.gather(0, first[None])[0],
                    s_f.reshape(n_inst, n).gather(0, first[None])[0], first)

        old = results(old_query())
        if not (torch.equal(old[1], got[1]) and torch.equal(old[2].int(),
                                                            got[2])
                if closest else torch.equal(old[0], got[0])):
            raise AssertionError(f"instanced {kind} on wave 0 differs from "
                                 f"the earlier route")
        peaks = {}
        for name, fn in (("old", old_query), ("new", call)):
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - mem0
        nbytes, nops = instanced_work(im, o_, d_, tm_,
                                      got if closest else got[0], blk)
        dev_ms, q_ms = kernel_ms(call, "instanced_kernel", iters=5)
        pdev_ms, pq_ms = kernel_ms(period, "cluster_kernel", iters=5)
        iq[kind] = dict(
            rays=n, ms=time_ms(call, iters=5), device_ms=dev_ms,
            queued_ms=q_ms, period_ms=time_ms(period, iters=5),
            period_device_ms=pdev_ms, period_queued_ms=pq_ms,
            old_query_ms=time_ms(old_query, iters=5),
            plain_ms=time_ms(plain, iters=1), bound=bound_ms(nbytes, nops),
            old_query_bytes=peaks["old"], new_query_bytes=peaks["new"],
            max_abs_err=(((got[0] - ref[0]).abs()[got[1] >= 0].max().item()
                          if (got[1] >= 0).any() else 0.0) if closest
                         else (got[0] != ref[0]).float().max().item()),
            hit=((got[1] >= 0) if closest else got[0]).float().mean().item())
    # the instanced entries at every query of wave 0 as the kernel path
    # runs it (render/fuzz.py wave_queries): live rays and ms by events
    inst_bounces = []
    for q in fuzz.wave_queries(ds_i, cam_i, film_i, cfg_i,
                               integ.KERNEL_OPS):
        if not q["kind"].endswith("_instanced"):
            continue
        args = (q["w"], q["cbox"], q["itab"], q["o"], q["d"], q["tmax"],
                q["n_alive"])
        if q["kind"] == "closest_instanced":
            fn = functools.partial(ops.closest_hit_instanced, *args)
        else:
            fn = functools.partial(ops.any_hit_instanced, *args,
                                   q["blocked_in"])
        inst_bounces.append(dict(
            kind=q["kind"], ms=time_ms(fn, iters=5),
            live=n if q["n_alive"] is None else int(q["n_alive"])))
    for kind, row in (("closest", "closest_hit_instanced"),
                      ("any", "any_hit_instanced")):
        kern_rows[row] = dict(
            max_abs_err=iq[kind]["max_abs_err"], ms=iq[kind]["ms"],
            plain_ms=iq[kind]["plain_ms"], bound=iq[kind]["bound"])
    _say("[15] cb_inst.json (" f"{n_inst} instances of {im.attr.shape[0]} "
         f"triangles in {im.cw.shape[0]} clusters, "
         f"{ds_i.ktab.shape[0]} spheres, no world triangle): " + "; ".join(
             f"{r['set']}: world K1 / K2 with no cluster equal to plain "
             f"{r['world_equal']} ({r['sphere_lanes']} sphere lanes, no "
             f"descriptor {r['no_encode']}), instanced K1 / K2 on {n4} "
             f"rays equal to plain {r['instanced_equal']} (hit "
             f"{r['inst_hit']:.4f}, blocked {r['inst_blocked']:.4f}), "
             f"{n_inst} x {n4}-lane period launches equal to plain and to "
             f"the instanced entries {r['period_equal']}, dead lanes miss "
             f"{r['dead_lanes_miss']}, query hits agree "
             f"{r['query_hit_agree']:.6f}" for r in k15)
         + f" | 64x48 4spp depth 8: launches {inst_launches}; max |kernel "
         f"- plain| {dinst:.3e} (gate {PLAIN_ATOL}) | train step 64x48: "
         f"loss kernels {losses15['kernels']:.6e} plain "
         f"{losses15['plain']:.6e}; grad rel " + ", ".join(
             f"{k} {v:.2e}" for k, v in grel15.items())
         + f"; finite {finite15} | 256x256 16spp depth 8: {inst_rate:.0f} "
         f"paths/s (no sphere test outside K1 / K2) | one wave "
         f"{1e3 * iwave_s:.1f} ms, kernel launches {iwave_launches}, TMA "
         f"encodes {iwave_encodes}, batched products {ibmm}, peak memory "
         f"{iwave_mem / 2**20:.1f} MiB, device busy {1e3 * ibusy:.1f} ms in "
         f"{ink} launches (share {ibusy / iwave_s:.2f}), of which "
         + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in iown.items())
         + f" | cb.json plus cb_inst's instances: TMA encodes {mix_first} in"
         f" the first wave, {mix_encodes} in the next "
         f"({mix_launches['closest_hit']} K1 / {mix_launches['any_hit']} K2 "
         f"+ {mix_launches['closest_hit_instanced']} / "
         f"{mix_launches['any_hit_instanced']} instanced launches) | per "
         f"instanced query on wave 0 ({n} rays): " + "; ".join(
             f"{'K1' if k == 'closest' else 'K2'}: equal to plain, hit / "
             f"blocked {v['hit']:.4f}, {v['ms']:.4f} ms by events (device "
             f"{v['device_ms']:.4f}, queued {v['queued_ms']:.4f}) vs bound "
             f"{v['bound'][0]:.4f} ms ({v['bound'][1]}), plain "
             f"{v['plain_ms']:.1f} ms; the period launch over "
             f"{n_inst * n} lanes {v['period_ms']:.4f} ms (device "
             f"{v['period_device_ms']:.4f}, queued "
             f"{v['period_queued_ms']:.4f}), the earlier query whole "
             f"{v['old_query_ms']:.4f} ms; peak memory of the query "
             f"{v['old_query_bytes'] / 2**20:.1f} MiB before, "
             f"{v['new_query_bytes'] / 2**20:.2f} MiB now"
             for k, v in iq.items())
         + " | the instanced launches of wave 0 (live rays: ms): " + ", ".join(
             f"{'K1' if b['kind'] == 'closest_instanced' else 'K2'} "
             f"{b['live']}: {b['ms']:.4f}" for b in inst_bounces)
         + f" ({card})")

    # phase 16: the Whitted and bidirectional (BPT) renderers on cb.json
    from arendur_tpu_torch.render import bpt, whitted
    # BPT's own sets: wave 0 of the 256x256, 16 spp, depth-8 render, as
    # the kernel path ran it (render/fuzz.py bpt_wave_sets)
    with torch.no_grad():
        before = ops.SLOT_ORDER.launches
        sets = fuzz.bpt_wave_sets(ds, camera, film_cfg, config,
                                  integ.KERNEL_OPS)
        sets_orders = ops.SLOT_ORDER.launches - before
    q16 = {}
    for q in sets["queries"]:
        closest = q["kind"] == "closest"
        call = query_call(ops.closest_hit if closest else ops.any_hit, ds, q)
        plain = query_call(ci.intersect_clusters_reference if closest
                           else ci.occluded_clusters_reference, ds, q)
        got, ref = results(call()), results(plain())
        rec = (q["t"], q["slot"]) if closest else (q["blocked"],)
        recorded = all(torch.equal(a, b) for a, b in zip(got, rec))
        lanes = (got[-1] == ref[-1]).float().mean().item()
        err = 0.0
        if closest:
            hit = (got[1] == ref[1]) & (got[1] >= 0)
            if hit.any():
                err = (got[0] - ref[0]).abs()[hit].max().item()
                trel = ((got[0] - ref[0]).abs()[hit]
                        / ref[0].abs()[hit]).max().item()
                if trel > T_RTOL:
                    raise AssertionError(f"K1 on BPT's {q['tag']}: t rel "
                                         f"{trel}")
        nbytes, nops = wave_query_work(ds, q, got)
        q16[q["tag"]] = dict(
            kind=q["kind"], lanes_equal=lanes, recorded=recorded,
            max_abs_err=err, hit=(got[-1] != (0 if not closest else -1))
            .float().mean().item(), ms=time_ms(call, iters=3),
            plain_ms=time_ms(plain, iters=1), bytes=nbytes, ops=nops)
        q16[q["tag"]]["bound_ms"] = bound_ms(nbytes, nops)[0]
        if lanes < K1_K2_GATE or not recorded:
            raise AssertionError(f"K1 / K2 on BPT's {q['tag']}: "
                                 f"{q16[q['tag']]}")
    # K8 / K9 on every BSDF sample and fused evaluation of the wave,
    # equal to the bit, each BSDF's recipe order (built once, as the
    # wave ran) equal to its plain twin; their times on four of the
    # calls each
    bsdfs = {id(r["b"]): r["b"] for r in sets["samples"] + sets["evals"]}
    orders16 = dict(bsdfs=len(bsdfs), built=sets_orders, err=max(
        order_err(b_) for b_ in bsdfs.values()))
    if orders16["built"] != orders16["bsdfs"] or orders16["err"]:
        raise AssertionError(f"BPT's recipe orders: {orders16}")
    kern_rows["slot_order"]["max_abs_err"] = max(
        kern_rows["slot_order"]["max_abs_err"], orders16["err"])
    k16_89 = {}
    for name, recs, plain_fn in (
            ("slot_sample", sets["samples"], sl.bsdf_sample),
            ("slot_eval_pdf", sets["evals"], sl.bsdf_eval_pdf)):
        diff = lanes = 0
        for r in recs:
            x2 = r["u"] if name == "slot_sample" else r["wi"]
            ref = plain_fn(r["b"], r["wo"], x2, r["types"])
            diff += sum(bit_diff(a.float(), b.float())
                        for a, b in zip(r["out"], ref))
            lanes += r["wo"].shape[0]
        if diff:
            raise AssertionError(f"{name} on BPT's calls: {diff} elements "
                                 f"differ from the plain version")
        pick = recs[::max(1, len(recs) // 4)][:4]
        times, pms, nb, nop = [], [], [], []
        for r in pick:
            x2 = r["u"] if name == "slot_sample" else r["wi"]
            times.append(slot_entry_times(r["b"], r["wo"], x2, r["types"],
                                          name == "slot_sample", iters=5))
            pms.append(time_ms(lambda: plain_fn(r["b"], r["wo"], x2,
                                                r["types"]), iters=2))
            cols = (ssh.SAMPLE_IN_COLS + ssh.SAMPLE_OUT_COLS
                    if name == "slot_sample"
                    else ssh.EVAL_IN_COLS + ssh.EVAL_OUT_COLS)
            nb.append(4 * r["wo"].shape[0] * cols)
            nop.append(plain_ops(lambda: plain_fn(r["b"], r["wo"], x2,
                                                  r["types"])))
        mean_t = {k: sum(t[k] for t in times) / len(times) for k in times[0]}
        k16_89[name] = dict(calls=len(recs), lanes=lanes,
                            ms=mean_t["sweep"], times=mean_t,
                            plain_ms=sum(pms) / len(pms),
                            bound=bound_ms(sum(nb) / len(nb),
                                           sum(nop) / len(nop)))
    del sets
    # the 64x48, 8 spp, depth-8 BPT render and the 64x48, 32 spp Whitted
    # render through the kernels against the plain path
    s16, cam16, film16, cfg16, _ = scenedesc.parse_scene(
        cb_json, spp_override=8, resolution_override=(64, 48))
    cfg16 = dataclasses.replace(cfg16, max_depth=8, wave_size=1 << 16)
    ds16 = sc.DeviceScene.build(s16, dev)
    cfg16w = dataclasses.replace(cfg16, spp=32, sample_dx=4, sample_dy=8)
    ops.reset_counts()
    img_bk = bpt.render_bpt(ds16, cam16, film16, cfg16)
    torch.cuda.synchronize()
    bpt_launches = ops.counts()
    img_bp = bpt.render_bpt(ds16, cam16, film16, cfg16,
                            ops=integ.PLAIN_OPS)
    ops.reset_counts()
    img_wk = whitted.render_whitted(ds16, cam16, film16, cfg16w)
    torch.cuda.synchronize()
    wh_launches = ops.counts()
    img_wp = whitted.render_whitted(ds16, cam16, film16, cfg16w,
                                    ops=integ.PLAIN_OPS)
    dbpt = float((img_bk - img_bp).abs().max().item())
    dwh = float((img_wk - img_wp).abs().max().item())
    for nm, img_, lau, need in (
            ("BPT", img_bk, bpt_launches, COMPOSED_KERNELS),
            ("Whitted", img_wk, wh_launches,
             ("closest_hit", "any_hit", "closest_hit_spheres",
              "any_hit_spheres", "slot_eval_pdf"))):
        if not torch.isfinite(img_).all() or img_.shape != (48, 64, 3) \
                or not img_.max() > 0.0:
            raise AssertionError(f"{nm} render is not finite [48,64,3]")
        if min(lau[k] for k in need) < 1 or any(
                lau[k] for k in ("bounce_shade", "hit_shade", "shade_split")):
            raise AssertionError(f"{nm} path launches: {lau}")
    if wh_launches["slot_sample"]:
        raise AssertionError(f"Whitted sampled a BSDF: {wh_launches}")
    if max(dbpt, dwh) > PLAIN_ATOL:
        raise AssertionError(f"BPT / Whitted kernel and plain paths differ: "
                             f"{dbpt}, {dwh}")
    if out_dir:
        np.save(os.path.join(out_dir, "cornell_bpt_64x48_kernels.npy"),
                img_bk.cpu().numpy())
        np.save(os.path.join(out_dir, "cornell_whitted_64x48_kernels.npy"),
                img_wk.cpu().numpy())
    # paths/s at 256x256, 16 spp, depth 8 on the kernel path (no sphere
    # test outside K1 / K2); BPT renders the whole frame where two waves
    # say it takes at most 60 s, else its rate is that of the timed waves
    wave16 = (ds, camera, config, film_cfg, pxy, pid, sid,
              smp.make_base_key(0))
    with torch.no_grad():
        bpt.trace_wave_bpt(*wave16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            bpt.trace_wave_bpt(*wave16)
        torch.cuda.synchronize()
        bwave_s = (time.perf_counter() - t0) / 2
    n_frame = 256 * 256 * 16
    bpt_whole = bwave_s * n_frame / n <= 60.0
    with sphere_tests_refused():
        if bpt_whole:
            t0 = time.perf_counter()
            img_bf = bpt.render_bpt(ds, camera, film_cfg, config)
            torch.cuda.synchronize()
            bpt_rate = n_frame / (time.perf_counter() - t0)
            if not torch.isfinite(img_bf).all():
                raise AssertionError("BPT 256x256 render not finite")
        else:
            bpt_rate = n / bwave_s
        whitted.render_whitted(ds, camera, film_cfg, dataclasses.replace(
            config, spp=1, sample_dx=1, sample_dy=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_wf = whitted.render_whitted(ds, camera, film_cfg, config)
        torch.cuda.synchronize()
        wh_rate = n_frame / (time.perf_counter() - t0)
    if not torch.isfinite(img_wf).all():
        raise AssertionError("Whitted 256x256 render not finite")
    # one BPT wave: its launches, host ops, device busy share and each
    # kernel's launches and device ms
    with torch.no_grad():
        ops.reset_counts()
        t0 = time.perf_counter()
        bpt.trace_wave_bpt(*wave16)
        torch.cuda.synchronize()
        bw_s = time.perf_counter() - t0
        bw_launches = ops.counts()
        bprof = wave_profile(lambda: bpt.trace_wave_bpt(*wave16))
        bslots = slot_wave_ms(bprof)
    bbusy, bnk, _ = _busy_s(bprof)
    host_ops = sum(1 for e in bprof.events()
                   if e.device_type.name == "CPU" and e.cpu_parent is None
                   and e.name.startswith("aten::"))
    per_k = {}
    for e in bprof.events():
        if e.device_type.name != "CUDA" or e.time_range.end <= 0:
            continue
        k = ("K1" if "cluster_kernel<false" in e.name else
             "K2" if "cluster_kernel<true" in e.name else
             "K1 / K2" if "cluster_kernel" in e.name else
             "K8" if "slot_sample_kernel" in e.name else
             "K9" if "slot_eval_pdf_kernel" in e.name else
             "K8 / K9 order" if "slot_order" in e.name else "other")
        c, t_ = per_k.get(k, (0, 0.0))
        per_k[k] = (c + 1, t_ + 1e-3 * (e.time_range.end
                                        - e.time_range.start))
    light0 = q16["light walk 0"]
    k1_rest = min(v["lanes_equal"] for t, v in q16.items()
                  if v["kind"] == "closest" and t != "light walk 0")
    bpt_rows = {
        "closest_hit": [v for v in q16.values() if v["kind"] == "closest"],
        "any_hit": [v for v in q16.values() if v["kind"] == "any"]}
    bpt_kern = {}
    for k, rows_k in bpt_rows.items():
        mean = lambda key: sum(r[key] for r in rows_k) / len(rows_k)  # noqa
        bpt_kern[k] = dict(ms=mean("ms"), plain_ms=mean("plain_ms"),
                           bound=bound_ms(mean("bytes"), mean("ops")),
                           queries=len(rows_k),
                           lanes_equal=min(r["lanes_equal"] for r in rows_k))
    for k, v in k16_89.items():
        bpt_kern[k] = v
    _say("[16] Whitted and BPT on cb.json | BPT's wave-0 sets (256x256 16spp "
         f"depth 8, {len(q16)} queries): K1 light walk 0 (rays started 1e-4 "
         f"off the sphere lights) lanes equal to plain "
         f"{light0['lanes_equal']:.6f}, hit {light0['hit']:.4f}; other K1 "
         f"queries min lanes equal {k1_rest:.6f}; K2 "
         f"({len(bpt_rows['any_hit'])} connection / lens queries) min lanes "
         f"equal {bpt_kern['any_hit']['lanes_equal']:.6f}; per launch "
         + "; ".join(
             f"{k} {v['ms']:.4f} ms vs bound {v['bound'][0]:.4f} ms "
             f"({v['bound'][1]}), plain {v['plain_ms']:.3f} ms"
             for k, v in bpt_kern.items())
         + f"; K8 {k16_89['slot_sample']['calls']} calls / K9 "
         f"{k16_89['slot_eval_pdf']['calls']} calls equal to the bit, "
         f"{orders16['built']} recipe orders for {orders16['bsdfs']} BSDFs, "
         f"max |order - plain twin| {orders16['err']}; K8 / K9 ms per "
         "call by events, the mean of four calls (rotated): " + "; ".join(
             f"{k} " + ", ".join(f"{t}: {v:.4f}" for t, v in
                                 k16_89[k]["times"].items())
             for k in ("slot_sample", "slot_eval_pdf"))
         + " | one BPT wave's (launches, device ms) of "
         + slot_wave_text(bslots) + " | "
         f"64x48 BPT 8spp depth 8: launches {bpt_launches}; max |kernel - "
         f"plain| {dbpt:.3e} | 64x48 Whitted 32spp: launches {wh_launches}; "
         f"max |kernel - plain| {dwh:.3e} (gate {PLAIN_ATOL}) | 256x256 16spp "
         f"depth 8: BPT {bpt_rate:.0f} paths/s ("
         + ("whole frame" if bpt_whole else
            f"two timed waves of {n}: the frame would take "
            f"{bwave_s * n_frame / n:.0f} s")
         + f"), Whitted {wh_rate:.0f} paths/s (no sphere test outside K1 / "
         f"K2) | one BPT wave {1e3 * bw_s:.1f} ms, kernel launches "
         f"{bw_launches}, {host_ops} top-level aten ops, device busy "
         f"{1e3 * bbusy:.1f} ms in {bnk} launches (share {bbusy / bw_s:.2f})"
         ", per kernel (launches, device ms) " + ", ".join(
             f"{k} ({c}, {t_:.2f})" for k, (c, t_) in sorted(per_k.items()))
         + f" ({card})")

    p17 = phase17(dev, card, ds, camera, film_cfg, config, (pxy, pid, sid))
    p18 = phase18(dev, card, ds, camera, film_cfg, config)
    p19 = phase19(dev, card, big_tables, scratch)
    p20 = phase20(dev, card, big_tables, scratch, (mse_ds4, dmean))
    p21 = phase21(dev, card, scratch)

    src = "arendur_tpu_torch/kernels/"
    meta = {
        "closest_hit": (src + "intersect.cu",
                        "arendur_tpu/shapes/pallas_intersect.py:138"),
        "any_hit": (src + "intersect.cu",
                    "arendur_tpu/shapes/pallas_intersect.py:195"),
        "closest_hit_spheres": (src + "intersect.cu",
                                "arendur_tpu/shapes/pallas_intersect.py:102"),
        "any_hit_spheres": (src + "intersect.cu",
                            "arendur_tpu/shapes/pallas_intersect.py:102"),
        "closest_hit_instanced": (
            src + "intersect.cu", "arendur_tpu/shapes/pallas_intersect.py:138"),
        "any_hit_instanced": (
            src + "intersect.cu", "arendur_tpu/shapes/pallas_intersect.py:195"),
        "bounce_shade": (src + "cbounce.cu",
                         "arendur_tpu/render/cbounce.py:955"),
        "bounce_shade_bwd": (src + "cbounce_bwd.cu",
                             "arendur_tpu/render/cbounce.py:1051"),
        "hit_shade": (src + "cbounce_split.cu",
                      "arendur_tpu/render/cbounce.py:1189"),
        "shade_split": (src + "cbounce_split.cu",
                        "arendur_tpu/render/cbounce.py:1235"),
        "bounce_shade_wide": (src + "cbounce.cu",
                              "arendur_tpu/render/pallas_bounce.py:264"),
        "slot_sample": (src + "slot_shade.cu",
                        "arendur_tpu/bxdf/pallas_shade.py:139"),
        "slot_eval_pdf": (src + "slot_shade.cu",
                          "arendur_tpu/bxdf/pallas_shade.py:189"),
        # K8 / K9's lane order: no TPU kernel of its own; it serves the
        # sweeps that replace the kernels of this pallas_call
        "slot_order": (src + "slot_shade.cu",
                       "arendur_tpu/bxdf/pallas_shade.py:117"),
    }
    main_launches = dict(train_launches)
    main_launches.update({k: tex_launches[k]
                          for k in ("hit_shade", "shade_split")})
    main_launches.update({k: comp_launches[k]
                          for k in ("slot_sample", "slot_eval_pdf",
                                    "slot_order")})
    main_launches["bounce_shade_wide"] = wide_launches["bounce_shade"]
    main_launches.update({k: inst_launches[k]
                          for k in ("closest_hit_instanced",
                                    "any_hit_instanced")})
    # phase 19's figures past the caps: K1-K4's launches in its train
    # step, K5 / K6's in its textured wave, each kernel's times there
    past_cap = {"closest_hit": "K1", "any_hit": "K2",
                "closest_hit_spheres": "K1", "any_hit_spheres": "K2",
                "bounce_shade": "K3", "bounce_shade_bwd": "K4",
                "hit_shade": "K5", "shade_split": "K6"}
    area_rows = {
        "bounce_shade": ("K3", p20["golden_launches"]),
        "bounce_shade_bwd": ("K4", p20["train_launches"]),
        "hit_shade": (None, p20["other"]["textured"]["launches"]),
        "shade_split": ("K6", p20["other"]["textured"]["launches"])}
    rows = []
    for k in TRAIN_KERNELS + ("hit_shade", "shade_split",
                              "bounce_shade_wide", "slot_sample",
                              "slot_eval_pdf", "slot_order",
                              "closest_hit_instanced",
                              "any_hit_instanced"):
        r = dict(kern_rows[k])
        b_ms, b_by = r.pop("bound")
        rows.append(dict(name=k, route="cuda", source=meta[k][0],
                         replaces=meta[k][1], launches=main_launches[k], **r,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        if k in bpt_launches and bpt_launches[k]:
            # the 64x48 BPT render's launches, and the kernel on BPT's
            # own wave-0 inputs (phase 16)
            rows[-1]["bpt_launches"] = bpt_launches[k]
            rows[-1]["bpt_wave_launches"] = bw_launches[k]
            if k in bpt_kern:
                rows[-1].update(bpt_ms=bpt_kern[k]["ms"],
                                bpt_plain_ms=bpt_kern[k]["plain_ms"],
                                bpt_bound_ms=bpt_kern[k]["bound"][0])
        if p18["nccl_step_launches"].get(k):
            # the one-rank NCCL group's sharded render and train step
            rows[-1]["sharded_launches"] = p18["nccl_launches"][k]
            rows[-1]["sharded_train_launches"] = \
                p18["nccl_step_launches"][k]
        for isec in ("bvh", "naive"):
            if p17[isec]["render_launches"].get(k):
                # the 64x48 render with the world triangles met by the
                # BVH walk / the brute force, and one 65,536-lane wave
                rows[-1][isec + "_launches"] = p17[isec]["render_launches"][k]
                rows[-1][isec + "_wave_launches"] = \
                    p17[isec]["wave_launches"][k]
        if k in past_cap:
            t19 = p19["times"]["lights"][past_cap[k]]
            rows[-1].update(
                past_cap_launches=(p19["train_launches"][k]
                                   if k in TRAIN_KERNELS
                                   else p19["textured_wave_launches"][k]),
                past_cap_ms=t19["ms"], past_cap_device_ms=t19["device_ms"],
                past_cap_bound_ms=t19["bound"][0])
        if k in area_rows:
            # phase 20, area-uniform sphere-light sampling: the launches
            # in its golden render (K3), train step (K4) and textured
            # render (K5 / K6), and K3 / K4 / K6's device ms on cb.json's
            # first bounce beside compat's in the same run
            key, lau = area_rows[k]
            rows[-1]["area_launches"] = lau[k]
            if key:
                t20 = p20["times"]["cb.json"]
                rows[-1].update(area_device_ms=t20[key + " area"],
                                area_compat_device_ms=t20[key + " compat"])
        if k in ("closest_hit", "any_hit"):
            # phase 21, the mesh of ~10^6 triangles: the launches in its
            # wave, and the ms on wave 0's camera / shadow query there
            t21 = p21["times"]["camera" if k == "closest_hit" else "shadow"]
            rows[-1].update(big_mesh_launches=p21["launches"][k],
                            big_mesh_ms=t21["ms"],
                            big_mesh_device_ms=t21["device_ms"],
                            big_mesh_bound_ms=t21["bound_ms"])
        if b_ms > r["ms"]:
            raise AssertionError(f"{k}: {r['ms']} ms is below its bound "
                                 f"{b_ms} ms")
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, kernels=rows, paths_per_s=rates,
                           mse_ds4=mse_ds4, dmean=dmean, dplain=dplain,
                           k1=k1, k2=k2, k3=k3, k4=k4, ptxas=ptxas,
                           train_grad_rel=grel, train_losses=losses,
                           fwd_bwd=fb, step_s=step_s, step_busy_s=busy,
                           step_k4_ms=k4_step_ms, step_k4_calls=k4_calls,
                           step_kernel_s=own, k5_k6=k56,
                           split_vs_fused=[sf_close, sf_flags, sf_exact],
                           textured_launches=tex_launches,
                           textured_dplain=dtex,
                           textured_paths_per_s=tex_rates,
                           textured_wave_s=wave_s,
                           textured_wave_busy_s=wbusy,
                           textured_wave_launches=wnk,
                           textured_wave_kernel_s=wown,
                           untextured_wave=[uwave_s, ubusy, unk],
                           k5_k6_k3_device_ms=[k5_dev, k6_dev, k3_dev],
                           k5_k6_k3_queued_ms=[k5_q, k6_q, k3_q],
                           k5_k6_plain_ops=[k5_ops, k6_ops],
                           k8_k9=k89, k8_k9_device_ms=[k8_dev, k9_dev],
                           k8_k9_queued_ms=[k8_q, k9_q],
                           k8_k9_plain_ops=[k8_ops, k9_ops],
                           k8_k9_first_bounce_ms=dict(k8=t8, k9=t9),
                           order_queued_ms=ord_q, order_plain_ops=ord_ops,
                           composed_slot_wave=cslots,
                           bpt_slot_wave=bslots,
                           bpt_orders=orders16,
                           composed_launches=comp_launches,
                           composed_dplain=dcomp, forced_vs_fused=dforced,
                           composed_paths_per_s=comp_rates,
                           composed_wave=[cwave_s, cbusy, cnk],
                           composed_wave_launches=wave_launches,
                           composed_wave_kernel_s=cown,
                           k7=k7, k7_device_ms=k7_dev, k7_queued_ms=k7_q, k7_plain_ops=k7_ops,
                           wide_launches=wide_launches, wide_dmax=dwide,
                           k14=k14, k14_times=k14_times, tie_set=tie,
                           wave_queries=wave_q, k1_k2_twice=twice,
                           occupancy=occ, k15=k15,
                           inst_launches=inst_launches, inst_dplain=dinst,
                           inst_train_grad_rel=grel15,
                           inst_train_losses=losses15,
                           inst_train_launches=step15_launches,
                           inst_paths_per_s=inst_rate,
                           inst_wave=[iwave_s, ibusy, ink],
                           inst_wave_launches=iwave_launches,
                           inst_wave_kernel_s=iown,
                           inst_wave_encodes=iwave_encodes,
                           mixed_encodes=[mix_first, mix_encodes],
                           inst_queries={k: dict(v, bound=list(v["bound"]))
                                         for k, v in iq.items()},
                           inst_bounces=inst_bounces,
                           inst_wave_batched_products=ibmm,
                           inst_wave_peak_bytes=iwave_mem,
                           bpt_queries=q16,
                           bpt_kernels={k: dict(v, bound=list(v["bound"]))
                                        for k, v in bpt_kern.items()},
                           bpt_launches=bpt_launches,
                           whitted_launches=wh_launches,
                           bpt_dplain=dbpt, whitted_dplain=dwh,
                           bpt_paths_per_s=bpt_rate,
                           bpt_whole_frame=bpt_whole,
                           whitted_paths_per_s=wh_rate,
                           bpt_wave=[bw_s, bbusy, bnk, host_ops],
                           bpt_wave_launches=bw_launches,
                           bpt_wave_kernels=per_k, phase17=p17,
                           phase18=p18, phase19=p19, phase20=p20,
                           phase21=p21),
                      f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
