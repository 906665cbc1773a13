"""Process-group setup for runs over several ranks (port of
`activegs_tpu/runtime.py::init_distributed`).

Opt-in: `init_distributed` does nothing unless the environment asks for
it, with ACTIVEGS_DISTRIBUTED=1 or with torchrun's RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT (all four; a partial set is an error). After it,
`IncrementalMapper` splits training views and planner candidates over the
ranks (`parallel/sharded.py`). The reference's compile cache and XLA flags
have no counterpart here (`render/_build.py` keeps the kernel builds).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str | None = None) -> bool:
    """Join the default process group that the environment describes.
    Returns False, doing nothing, unless ACTIVEGS_DISTRIBUTED=1 or one of
    torchrun's variables is set; raises when only part of RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT is given.

    The backend is `backend`, else ACTIVEGS_DIST_BACKEND, else nccl where
    CUDA is available and gloo where it is not. NCCL takes one rank a card:
    with more ranks than cards it raises rather than switch backends; gloo
    serves CPU ranks and ranks that share a card. Each rank's device is
    cuda:(LOCAL_RANK % cards). Returns True once the group is up."""
    given = [k for k in ENV if os.environ.get(k)]
    if os.environ.get("ACTIVEGS_DISTRIBUTED", "0") in ("", "0") and not given:
        return False
    missing = [k for k in ENV if k not in given]
    if missing:
        raise RuntimeError(
            f"a distributed run needs all of {', '.join(ENV)} in the environment (torchrun sets them); "
            f"missing {', '.join(missing)}"
        )
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = backend or os.environ.get("ACTIVEGS_DIST_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo"
    )
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and world > cards:
        raise RuntimeError(
            f"nccl takes one rank a card: {world} ranks on {cards} card(s); pass backend='gloo' "
            "(or ACTIVEGS_DIST_BACKEND=gloo) for ranks that share a card or run on the CPU"
        )
    if cards:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method="env://", rank=rank, world_size=world)
    return True
