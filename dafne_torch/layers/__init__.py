"""Layers of the port that are not models of their own (deformable conv)."""
