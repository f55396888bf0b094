"""Logging setup with per-process prefixes (the JAX package's
``utils/logs.py`` for the port): every record carries ``[rankI/N]``, from
``torch.distributed`` when a process group is up, else ``rank0/1``."""

from __future__ import annotations

import logging

import torch.distributed as dist

log = logging.getLogger("mpi_knn_tpu_torch")


class _RankPrefix(logging.Filter):
    """Resolves the [rankI/N] prefix at emit time, so a logger set up before
    ``init_process_group`` still names the right rank."""

    def filter(self, record: logging.LogRecord) -> bool:
        if dist.is_available() and dist.is_initialized():
            record.host = f"rank{dist.get_rank()}/{dist.get_world_size()}"
        else:
            record.host = "rank0/1"
        return True


def setup_logging(verbosity: int = 0, quiet: bool = False) -> logging.Logger:
    """Configure the port's logger: WARNING by default, INFO at -v, DEBUG
    at -vv, ERROR when quiet."""
    level = logging.WARNING
    if quiet:
        level = logging.ERROR
    elif verbosity >= 2:
        level = logging.DEBUG
    elif verbosity == 1:
        level = logging.INFO

    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s [%(host)s] %(name)s %(levelname)s: %(message)s",
            datefmt="%H:%M:%S",
        )
    )
    handler.addFilter(_RankPrefix())
    log.handlers.clear()
    log.addHandler(handler)
    log.setLevel(level)
    log.propagate = False
    return log
