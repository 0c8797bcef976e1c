"""Physics of one frame over a batch of envs: state, draw-slot RNG, input
decoding, ball, players, collisions, the landing simulation (plain version
and CUDA kernel wrapper), the rule AI and the frame orchestrator."""
