"""The plain reference of the benchmark: the port's FV2P and MGAF-3DSSD model
code frozen at commit c8e3fcd, with the kernels' plain PyTorch versions in
place of the CUDA ones and the numpy rulebook builder. It imports nothing of
the port; each module says which file it was frozen from and what was cut."""
