"""Host helpers of the port (reference: core/utils.py:78-116)."""

from __future__ import annotations

import logging

import torch

from edgerunner_tpu_torch.config import vocab_size_for


def get_tokenizer(opt):
    """(tokenizer, vocab_size) for an Options (reference: core/utils.py:78-86)."""
    tokenizer = None
    if opt.use_meto:
        from edgerunner_tpu_torch.tokenizer import Engine

        tokenizer = Engine(discrete_bins=opt.discrete_bins, backend=opt.meto_backend)
    return tokenizer, vocab_size_for(opt)


_FACE_BOUNDS = (0, 1000, 2000, 4000, 8000)


def quantize_num_faces(n: torch.Tensor) -> torch.Tensor:
    """Bucket face counts: 0 uncond, 1 <=1000, 2 <=2000, 3 <=4000, 4 <=8000,
    5 above (reference: core/utils.py:89-116)."""
    bounds = torch.tensor(_FACE_BOUNDS, device=n.device)
    return (n[..., None] > bounds).sum(-1)


def init_logger(filename: str) -> logging.Logger:
    """A logger that writes to `filename` and to the terminal
    (edgerunner_tpu/utils/misc.py:57-71)."""
    logger = logging.getLogger("edgerunner_tpu_torch")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    for handler in (logging.FileHandler(filename, mode="w"), logging.StreamHandler()):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger
