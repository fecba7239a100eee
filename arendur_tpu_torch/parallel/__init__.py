"""Training over the differentiable render."""
