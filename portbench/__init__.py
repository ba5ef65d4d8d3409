"""The benchmark of the PyTorch and CUDA port (`your_voice_tts_torch`):
`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once on the card. It imports torch, numpy
and the port, never JAX or the JAX package."""
