"""The benchmark's plain reference: the configurations' forward passes in
plain PyTorch and fp32, from the same bf16 weights the program serves,
upcast one layer at a time. It imports nothing of the program."""
