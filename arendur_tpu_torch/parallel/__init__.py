"""Training and rendering over several devices: the train step, and
the sharded render and train step over torch.distributed, one process
per device (replaces the reference's rayon tile pool, ref:
pt.rs:163-167)."""
