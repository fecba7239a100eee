"""Port of arendur_tpu.bxdf."""
