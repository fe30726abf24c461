"""Process-group initialisation — the multi-process layer of the runtime.

The counterpart of the reference package's ``parallel/multihost.py``, which
calls ``jax.distributed.initialize``.  Here it is
``torch.distributed.init_process_group``: NCCL when the ranks run on the card,
gloo when the caller asks for the CPU.  One process drives one device; with
``torchrun --nproc_per_node k`` the arguments come from its environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from opticalflowscivis_tpu_torch.device import resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def local_device(device: str | torch.device | None = None) -> torch.device:
    """This process's device: the CPU when asked for, else ``cuda:LOCAL_RANK``
    modulo the visible cards (so that ranks may share one card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _summary(initialized: bool, cpu: bool, reason: str | None = None) -> dict:
    if initialized:
        # one device a process, so the group spans as many as it has processes
        return {"initialized": True, "process_index": dist.get_rank(),
                "process_count": dist.get_world_size(), "n_devices": dist.get_world_size()}
    cards = 0 if cpu or not torch.cuda.is_available() else torch.cuda.device_count()
    return {"initialized": False, "reason": reason, "process_index": 0, "process_count": 1,
            "n_devices": cards or 1}


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = 1800.0,
    backend: str | None = None,
) -> dict:
    """Initialise the default process group (a no-op when it already is).

    - ``coordinator_address`` ``"host:port"`` (or a rendezvous URL,
      ``tcp://...`` or ``file://...``), ``num_processes`` and ``process_id``
      given: a rendezvous there;
    - none given: ``torchrun``'s environment; without it (no cluster), no
      group, and the single-process summary.

    ``device`` None means the card (NCCL backend, ``cuda:LOCAL_RANK`` made
    current); ``"cpu"`` the gloo backend.  ``backend`` overrides the choice
    (``"gloo"`` lets several ranks share one card).  ``timeout_s`` bounds the
    rendezvous and every collective after it.  Returns a summary dict for
    logging, with the reference's keys.
    """
    cpu = device is not None and torch.device(device).type == "cpu"
    if dist.is_initialized():
        return _summary(True, cpu)
    if coordinator_address is None and num_processes is None:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            return _summary(False, cpu, f"no process group: {', '.join(missing)} not set "
                                        "(launch with torchrun, or pass the coordinator)")
        init = dict(init_method="env://")
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("pass coordinator_address, num_processes and process_id "
                             "together (or none of them, to read torchrun's environment)")
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        init = dict(init_method=url, world_size=num_processes, rank=process_id)
    if not cpu:
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            timeout=datetime.timedelta(seconds=timeout_s), **init)
    return _summary(True, cpu)
