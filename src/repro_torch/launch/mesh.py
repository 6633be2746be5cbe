"""The device mesh of the port's sharded runs, and its collectives.

Port of `repro/launch/mesh.py` together with the parts of `jax.sharding`
and `shard_map` the GP engine and the LM mesh use. The mesh is single-controller, as
the reference's is: one process holds every shard, runs each shard's
part of a generation in turn, and joins the shards where the reference
runs a collective. So `GPSession(topology=MeshTopology(data=2, model=2,
pod=2))` needs one process on any number of devices, and the same code
runs on one card, on several, or on the CPU (`device="cpu"`).

Axes, in the reference's order (`pod` first, and only when it is > 1):

  pod    island parallelism: the classic layout's independent
         sub-populations with ring migration, or the island layout's
         island axis
  data   dataset columns; each shard's fitness moments are merged
         across this axis. LM: the batch and the FSDP dim of the weights
  model  the population's rows. LM: heads, FFN hidden, experts, vocab

A `PartitionSpec` names, for each dimension of a tensor, the axis (or
tuple of axes, major first) its dimension is split over, or None for a
replicated dimension: the counterpart of `jax.sharding.PartitionSpec`.
`Mesh.split` turns a global tensor into its per-shard parts, each on its
shard's device, and `Mesh.join` turns them back into the global tensor
on the mesh's first device.

The collectives (`psum`, `pmean`, `all_gather`, `all_to_all`, `ppermute`,
`pmin`, `pmax`) are plain functions over the per-shard tensors of one
axis group, in rank order; each returns one result per shard, a copy on
that shard's own device. `over` applies one to every group of an axis.
`Sharded` holds a tensor as its per-shard parts (the LM's train state
and cache; the counterpart of a jax.Array with a `NamedSharding`), and
its `gather` is the all-gather whose backward adds each shard's gradient
into its part (the reduce-scatter). Nothing here reads a tensor back to
the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


class PartitionSpec(tuple):
    """Per dimension: an axis name, a tuple of names (major first) or
    None (replicated). Trailing dimensions not named are replicated. A
    one-name tuple is stored as the name, as JAX's spec stores it, so
    `tuple(spec)` equals the reference's `tuple(PartitionSpec(...))`."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = None if not p else (p[0] if len(p) == 1 else p)
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _names(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


class Mesh:
    """Named axes and one device per shard. Shards are numbered row-major
    over `axis_names` (the last axis fastest); `devices[s]` is shard s's
    device and `devices[0]` the mesh's home, where global tensors live."""

    def __init__(self, shape: dict, devices):
        self.axis_names = tuple(shape)
        for name in self.axis_names:
            if name not in AXES:
                raise ValueError(f"unknown mesh axis {name!r}; one of {AXES}")
        self.shape = {k: int(v) for k, v in shape.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes must be >= 1, got {self.shape}")
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.size:
            raise ValueError(f"a {self.shape} mesh has {self.size} shards, got "
                             f"{len(self.devices)} devices")

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def axis_size(self, axis) -> int:
        """Shards along `axis` (1 for None or an axis the mesh lacks)."""
        return self.shape.get(axis, 1) if axis else 1

    def coords(self, s: int) -> dict:
        """{axis: rank} of shard `s`."""
        out = {}
        for name in reversed(self.axis_names):
            s, out[name] = divmod(s, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank(self, s: int, axis) -> int:
        """Shard `s`'s rank along `axis` (0 for None or an absent axis)."""
        return self.coords(s).get(axis, 0) if axis else 0

    def groups(self, axis) -> list[list[int]]:
        """The shards that differ only in their rank along `axis`, one
        list per group in rank order (singletons for None or an axis the
        mesh lacks), groups in the order of their first shard."""
        if not axis or axis not in self.shape:
            return [[s] for s in range(self.size)]
        stride = math.prod(self.shape[a] for a in
                           self.axis_names[self.axis_names.index(axis) + 1:])
        n = self.shape[axis]
        return [[s + r * stride for r in range(n)] for s in range(self.size)
                if self.rank(s, axis) == 0]

    def _block(self, s: int, shape, spec) -> tuple:
        """Shard `s`'s slices of a global tensor of `shape` under `spec`."""
        c = self.coords(s)
        index = []
        for d, size in enumerate(shape):
            names = _names(spec[d]) if d < len(spec) else ()
            n = math.prod(self.axis_size(a) for a in names)
            if size % n:
                raise ValueError(f"dimension {d} of size {size} does not split "
                                 f"over {names} ({n} shards)")
            k = 0
            for a in names:
                k = k * self.axis_size(a) + c.get(a, 0)
            step = size // n
            index.append(slice(k * step, (k + 1) * step))
        return tuple(index)

    def check(self, shape, spec) -> None:
        """Raise ValueError unless a tensor of `shape` splits under `spec`."""
        self._block(0, shape, spec)

    def split(self, t, spec, shards=None) -> list:
        """The per-shard parts of global tensor `t` under `spec` (all
        shards, or those listed in `shards`), each contiguous on its
        shard's device."""
        t = torch.as_tensor(t)
        shards = range(self.size) if shards is None else shards
        return [t[self._block(s, t.shape, spec)].contiguous().to(self.devices[s])
                for s in shards]

    def owners(self, spec) -> list[int]:
        """The shards that hold each block of a tensor under `spec` once:
        rank 0 on every axis the spec does not name, in shard order."""
        named = {a for part in spec for a in _names(part)}
        return [s for s in range(self.size)
                if all(r == 0 for a, r in self.coords(s).items() if a not in named)]

    def join(self, parts, spec, device=None):
        """The global tensor on `device` (default: the home device) from
        per-shard `parts` (a list over the shards, or a dict holding at
        least the shards read here): each block comes from the first
        shard that holds it, rank 0 on every axis the spec does not name."""
        dev = self.home if device is None else torch.device(device)
        owners = self.owners(spec)
        first = parts[owners[0]]
        if len(owners) == 1:
            return first.to(dev)
        shape = list(first.shape)
        for d in range(min(len(spec), first.dim())):
            shape[d] *= math.prod(self.axis_size(a) for a in _names(spec[d]))
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        for s in owners:
            out[self._block(s, shape, spec)] = parts[s].to(dev)
        return out


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, device=None) -> Mesh:
    """A mesh over the cards of `resolve_device(device)` (default: every
    card of the process). Shard s goes to card s mod the card count, so
    one shard a card while there are cards enough, and the placement
    cycles where there are fewer cards than shards (8 shards on one card
    all share it, as the reference's fake host devices share one CPU).
    An indexed device (`cuda:1`) puts every shard on it; `device="cpu"`
    puts every shard on the CPU. Axes: ("pod", "data", "model") when
    pod > 1, else ("data", "model")."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    shape = {"pod": pod, "data": data, "model": model} if pod > 1 else {
        "data": data, "model": model}
    n = math.prod(shape.values())
    return Mesh(shape, [cards[s % len(cards)] for s in range(n)])


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: (data 16, model 16), or with `multi_pod`
    (pod 2, data 16, model 16), its shards on the cards as
    `make_host_mesh` places them."""
    return make_host_mesh(data=16, model=16, pod=2 if multi_pod else 1, device=device)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# --- collectives over the per-shard tensors of one axis group -----------------


def psum(parts: list) -> list:
    """The elementwise sum of `parts`, added in rank order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


def pmin(parts: list) -> list:
    """The elementwise minimum of `parts`."""
    low = parts[0]
    for p in parts[1:]:
        low = torch.minimum(low, p.to(low.device))
    return [low.to(p.device) for p in parts]


def pmax(parts: list) -> list:
    """The elementwise maximum of `parts`."""
    high = parts[0]
    for p in parts[1:]:
        high = torch.maximum(high, p.to(high.device))
    return [high.to(p.device) for p in parts]


def pmean(parts: list) -> list:
    """The elementwise mean of `parts`: their sum in rank order over
    their count."""
    return [t / len(parts) for t in psum(parts)]


def all_gather(parts: list, dim: int = 0, tiled: bool = False) -> list:
    """`parts` stacked along a new dimension `dim` in rank order, or
    with `tiled` concatenated along `dim`."""
    home = parts[0].device
    moved = [p.to(home) for p in parts]
    g = torch.cat(moved, dim) if tiled else torch.stack(moved, dim)
    return [g.to(p.device) for p in parts]


def all_to_all(parts: list, split_dim: int, concat_dim: int, tiled: bool = True) -> list:
    """Rank r splits its part into n equal chunks along `split_dim` and
    sends chunk j to rank j; rank j concatenates what it receives along
    `concat_dim` in rank order (`jax.lax.all_to_all`). Without `tiled`
    the split dimension has size n and is dropped, and the received
    chunks stack along a new `concat_dim`."""
    n = len(parts)
    size = parts[0].shape[split_dim]
    if size % n or (not tiled and size != n):
        raise ValueError(f"all_to_all: dimension {split_dim} of size {size} does not split "
                         f"over {n} ranks")
    chunks = [p.chunk(n, split_dim) for p in parts]
    out = []
    for j, dst in enumerate(parts):
        got = [chunks[r][j].to(dst.device) for r in range(n)]
        out.append(torch.cat(got, concat_dim) if tiled else
                   torch.stack([g.squeeze(split_dim) for g in got], concat_dim))
    return out


def ppermute(parts: list, perm) -> list:
    """Rank dst receives rank src's part for each (src, dst) of `perm`;
    a rank that receives nothing gets zeros."""
    out = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device)
    return [torch.zeros_like(p) if o is None else o for p, o in zip(parts, out)]


def over(mesh: Mesh, axis, fn, *parts, **kw):
    """Apply the group function `fn` (a collective, or any function of
    per-shard lists in rank order) to every group of `axis`. Each of
    `parts` is a dict {shard: value} holding whole groups; the result is
    a dict in the same form, or a tuple of them where `fn` returns a
    tuple of lists."""
    outs, single = ({},), True
    for group in mesh.groups(axis):
        members = [s for s in group if s in parts[0]]
        if not members:
            continue
        if len(members) != len(group):
            raise ValueError(f"shards {members} are not the whole {axis!r} group {group}")
        res = fn(*([p[s] for s in members] for p in parts), **kw)
        single = not isinstance(res, tuple)
        res = (res,) if single else res
        if len(outs) != len(res):
            outs = tuple({} for _ in res)
        for out, vals in zip(outs, res):
            out.update(zip(members, vals))
    return outs[0] if single else outs


# --- a tensor stored as per-shard parts ----------------------------------------


class _Gather(torch.autograd.Function):
    """The global tensor from a `Sharded`'s parts; the backward hands each
    part its block of the gradient (every shard that holds a block, the
    replicas too), so gradients of several gathers add up in the parts:
    the all-gather's transpose, a reduce-scatter."""

    @staticmethod
    def forward(ctx, sh, device, *parts):
        ctx.sh = sh
        return sh.mesh.join(parts, sh.spec, device)

    @staticmethod
    def backward(ctx, grad):
        sh = ctx.sh
        return (None, None, *(grad[sh.block(s)].to(p.device, copy=True).contiguous()
                              for s, p in enumerate(sh.parts)))


class Sharded:
    """A global tensor of `shape` stored as one part per shard of `mesh`,
    split by `spec` (`Mesh.split`); shards that hold the same block (the
    axes the spec does not name) keep copies of it, as the devices of a
    mesh do. `join` is the global tensor, `gather` the same as a step of
    autograd's graph, `assign` writes a global value into the parts."""

    def __init__(self, mesh: Mesh, spec, parts: list, shape):
        self.mesh, self.spec, self.parts = mesh, PartitionSpec(*spec), list(parts)
        self.shape = torch.Size(shape)

    @classmethod
    def place(cls, mesh: Mesh, t, spec) -> "Sharded":
        """`t`'s parts under `spec`, each a tensor of its own on its
        shard's device (no part aliases `t` or another part)."""
        t = torch.as_tensor(t)
        spec = PartitionSpec(*spec)
        parts = []
        for s in range(mesh.size):
            block = t[mesh._block(s, t.shape, spec)]
            parts.append(torch.empty(block.shape, dtype=t.dtype,
                                     device=mesh.devices[s]).copy_(block))
        return cls(mesh, spec, parts, t.shape)

    @classmethod
    def zeros(cls, mesh: Mesh, spec, shape, dtype=torch.float32) -> "Sharded":
        spec = PartitionSpec(*spec)
        shape = torch.Size(shape)
        return cls(mesh, spec, [torch.zeros([b.stop - b.start for b in mesh._block(s, shape, spec)],
                                            dtype=dtype, device=mesh.devices[s])
                                for s in range(mesh.size)], shape)

    def __repr__(self):
        return f"Sharded({tuple(self.shape)}, {self.spec!r}, {self.mesh.shape})"

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def block(self, s: int) -> tuple:
        """Shard `s`'s slices of the global tensor."""
        return self.mesh._block(s, self.shape, self.spec)

    def owners(self) -> list[int]:
        return self.mesh.owners(self.spec)

    def join(self, device=None) -> torch.Tensor:
        return self.mesh.join([p.detach() for p in self.parts], self.spec, device)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on `device`, differentiable in the parts."""
        dev = self.mesh.home if device is None else torch.device(device)
        if any(p.requires_grad for p in self.parts) and torch.is_grad_enabled():
            return _Gather.apply(self, dev, *self.parts)
        return self.mesh.join(self.parts, self.spec, dev)

    def assign(self, value) -> None:
        """Write the global tensor `value` into every part, in place."""
        with torch.no_grad():
            for s, p in enumerate(self.parts):
                p.copy_(value[self.block(s)])

    def with_parts(self, parts: list) -> "Sharded":
        """Another tensor of this layout (a gradient, a moment) from `parts`."""
        return Sharded(self.mesh, self.spec, parts, self.shape)
