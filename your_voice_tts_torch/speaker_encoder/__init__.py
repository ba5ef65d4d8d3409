"""GE2E speaker encoder (the JAX package's speaker_encoder/): the d-vector
network, its GE2E training (losses, the N x M batch sampler, the trainer),
and d-vectors for cloning."""
