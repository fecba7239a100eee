"""Render checkpoint / resume (port of the checkpoint half of
arendur_tpu/utils.py; SURVEY.md §5).

The render state is the film's rgb / weight sums, the next ray index
and the seed; the sampler is stateless (counter-based), so saving those
arrays makes a wave-chunked resume exact.  The files have the JAX
package's layout (``.npz`` keys rgb, weight, next_ray, seed and a JSON
meta holding padded and wave), so either package reads the other's.
(The reference has no checkpointing; its closest hook is
Sampler::set_sample_index, sample/mod.rs:93.)
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np
import torch

log = logging.getLogger("arendur_tpu_torch")


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
