"""Device meshes (airjax/parallel/mesh.py:1-36).

airjax lays a 1-D `jax.sharding.Mesh` over the time axis of the IQ stream
(or over channels) and lets XLA's collectives move the halo and gather the
candidates. Here a `Mesh` is an ordered list of torch devices and an axis
name; the decoders in halo.py and channels.py walk it in order, each shard
on its own device, and gather on the first one.

A mesh may repeat a device: eight shards on the CPU are the port's
counterpart of airjax's `xla_force_host_platform_device_count=8` test mesh
(tests/conftest.py), and several shards on one card run one after another
on that card's current stream (the block-decode kernel keeps a per-device
accumulator, so a card must never run two of them at once).

`make_mesh(n)` takes the first n cards and raises when fewer exist, as
airjax does; it never falls back to the CPU. A decode over several
processes (airjax's jax.distributed) is parallel/multihost.py: each
process holds a `Mesh` of its own shards; `init_distributed` joins the
job from the environment.

airjax's `time_sharding` and `replicated` (jax NamedShardings) have no
counterpart: the port places shards by hand (halo.shard_iq puts each
shard on its device, and the shard gather writes one buffer on the
mesh's first device).
"""

from __future__ import annotations

import dataclasses

import torch

TIME_AXIS = "t"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices` in shard order and the axis' name."""

    devices: tuple[torch.device, ...]
    axis: str = TIME_AXIS

    def __init__(self, devices, axis: str = TIME_AXIS):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devices}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a mesh takes CPU or CUDA devices of one kind, got {[str(d) for d in devices]}")
        if "cuda" in kinds:
            # An index, so that two names of one card compare equal.
            devices = tuple(torch.device("cuda", d.index if d.index is not None else torch.cuda.current_device())
                            for d in devices)
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis", axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as jax's `Mesh.shape`: an unknown axis raises KeyError."""
        return {self.axis: self.size}

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)


def make_mesh(n_devices: int | None = None, axis: str = TIME_AXIS, *, device: torch.device | str = "cuda") -> Mesh:
    """A mesh over the first `n_devices` cards (default: all of them), or
    with device="cpu" over `n_devices` CPU shards (default 1). Raises when
    fewer cards exist than asked for."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (1 if n_devices is None else n_devices), axis)
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind} devices")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n > have or n < 1:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def init_distributed() -> None:
    """Join a multi-process job from the environment (MASTER_ADDR,
    WORLD_SIZE, RANK) through multihost.init(); a no-op for a process
    alone, as airjax's (airjax/parallel/mesh.py:39-50)."""
    from airjax_torch.parallel import multihost  # multihost imports this module

    multihost.init()
