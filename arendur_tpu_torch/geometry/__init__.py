"""Port of arendur_tpu.geometry."""
