"""The CPU tests run tiny cells with windows of well under a second; a
worker that spins up every core's intra-op thread starves the others
under pytest-xdist, and a window then delivers nothing. Two threads a
worker keep them apart."""

import torch

torch.set_num_threads(2)
