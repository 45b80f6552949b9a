"""Architecture registry of the port: importing this package registers every
architecture whose model family the port runs (dense, with or without a
sliding window; ssm; hybrid, Zyphra's layout and a layer pattern given as
data; moe; vlm; encdec/audio), plus the paper's own DVB-S2 task chain in
``dvbs2.py``."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b, gemma3_1b, gemma3_12b, granite_4_0_h_small, internvl2_26b,
    kimi_k2_1t, mamba2_1_3b, phi3_medium_14b, stablelm_3b, whisper_small,
    zamba2_7b, zamba2_7b_instruct)
from repro_torch.configs import dvbs2  # noqa: F401
