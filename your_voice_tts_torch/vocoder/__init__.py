"""Neural vocoders (the JAX package's vocoder/): MelGAN and Parallel
WaveGAN generators, and WaveRNN with batched sequence folding. GAN
training (the discriminators, losses and trainer) comes with a later
slice."""
