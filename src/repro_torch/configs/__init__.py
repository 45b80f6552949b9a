"""Architecture registry of the port: importing this package registers every
architecture whose model family the port runs (the dense family)."""
from repro_torch.configs import phi3_medium_14b, stablelm_3b  # noqa: F401
