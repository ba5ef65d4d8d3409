"""GE2E speaker encoder (the JAX package's speaker_encoder/), inference
side: d-vectors for cloning."""
