"""PyTorch port of the KVFetcher reproduction, for one NVIDIA H100.

The package mirrors ``src/repro/`` module by module, so each module's
counterpart is found under the same path.  It imports ``torch`` and numpy
and keeps its own copies of the numpy-only modules it needs.  Device
hot spots are CUDA kernels written by hand for Hopper
(``repro_torch.kernels``); every entry point runs on the card unless the
caller passes ``device="cpu"``.
"""
