"""A frozen copy of the environment's frame code, for the benchmark's plain
reference: ball, players, collisions, the landing loop, the rule AI, the
counted threefry stream and the observations, in plain PyTorch on int32
tensors.  Later changes to the program do not reach it, so the yardstick
stays where it was set; only a benchmark change edits it."""
