"""Named profiling phases and render checkpoint / resume (port of
arendur_tpu/utils.py; SURVEY.md §5).

Named phases, like the reference's flame macros ("pt rendering" / "pt
add sample", pt.rs:129-157), add their host wall time to per-name
totals and label a torch.profiler trace (``record_function``, the
counterpart of jax.profiler.TraceAnnotation).  CUDA work is queued, so
a phase's wall time is the time to queue it unless the caller asks for
the card's time: ``reset_phase_totals(sync=True)`` makes each phase
synchronise the card where it starts and ends.  A render that nobody
asked for phases pays no synchronisation.

The render state is the film's rgb / weight sums, the next ray index
and the seed; the sampler is stateless (counter-based), so saving those
arrays makes a wave-chunked resume exact.  The files have the JAX
package's layout (``.npz`` keys rgb, weight, next_ray, seed and a JSON
meta holding padded and wave), so either package reads the other's.
(The reference has no checkpointing; its closest hook is
Sampler::set_sample_index, sample/mod.rs:93.)
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

log = logging.getLogger("arendur_tpu_torch")

_phase_totals: Dict[str, float] = {}
_phase_sync = False     # synchronise the card at the phases' edges


def _sync():
    if _phase_sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_phase(name: str):
    """Named phase: adds its wall time to the totals and labels a
    torch.profiler trace when one is recording."""
    _sync()
    start = time.perf_counter()
    with torch.autograd.profiler.record_function(name):
        yield
    _sync()
    _phase_totals[name] = _phase_totals.get(name, 0.0) \
        + (time.perf_counter() - start)


def phase_totals() -> Dict[str, float]:
    """Seconds per phase name since the last reset."""
    return dict(_phase_totals)


def reset_phase_totals(sync: bool = False):
    """Clear the totals; sync=True makes each later phase synchronise
    the card where it starts and ends, so that its total holds the
    card's time and not only the host's time to queue the work."""
    global _phase_sync
    _phase_totals.clear()
    _phase_sync = sync


def save_checkpoint(path: str, film_state, next_ray: int, seed: int,
                    meta: Optional[dict] = None):
    """Persist the film accumulators and the progress cursor to an
    .npz."""
    meta = dict(meta or {})
    meta["padded"] = bool(getattr(film_state, "padded", False))
    np.savez_compressed(
        path,
        rgb=film_state.rgb.detach().cpu().numpy(),
        weight=film_state.weight.detach().cpu().numpy(),
        next_ray=np.asarray(next_ray, np.int64),
        seed=np.asarray(seed, np.int64),
        meta=json.dumps(meta))


def load_checkpoint(path: str, device="cpu"):
    """Returns (film_state on `device`, next_ray, seed, meta) or None
    where no file exists."""
    from arendur_tpu_torch.filming.film import FilmState
    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    state = FilmState(rgb=torch.tensor(data["rgb"], device=device),
                      weight=torch.tensor(data["weight"], device=device),
                      padded=bool(meta.get("padded", False)))
    return state, int(data["next_ray"]), int(data["seed"]), meta
