"""Process topology for the artifact write discipline.

The port runs one process on one card; ``is_primary`` is the single
question the artifact writers ask (data/store.writer_store). It is True
unless a ``torch.distributed`` process group is up and this is not rank 0.
"""

from __future__ import annotations

import torch.distributed as dist


def is_primary() -> bool:
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)
