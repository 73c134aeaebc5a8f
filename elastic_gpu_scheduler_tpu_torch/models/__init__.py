"""Flagship decoder LM and its paged serving engine, in PyTorch."""
