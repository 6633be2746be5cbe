"""Core GP engine, ported to PyTorch: threefry keys, heap-tree
populations, the level-sweep evaluator, fitness kernels, breeding
operators and the block generation loop."""
