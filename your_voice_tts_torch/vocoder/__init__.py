"""Neural vocoders (the JAX package's vocoder/): WaveRNN with batched
sequence folding. MelGAN and PWGAN come with a later slice; their config
groups load already."""
