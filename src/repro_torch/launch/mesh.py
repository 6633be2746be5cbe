"""The device mesh of the port's sharded runs, and its collectives.

Port of `repro/launch/mesh.py` together with the parts of `jax.sharding`
and `shard_map` the GP engine and the LM mesh use. In one process the
mesh is single-controller: the process holds every shard, runs each
shard's part of a generation in turn, and joins the shards where the
reference runs a collective. So `GPSession(topology=MeshTopology(data=2,
model=2, pod=2))` needs one process on any number of devices, and the
same code runs on one card, on several, or on the CPU (`device="cpu"`).

Over several processes (`launch/cluster.init_cluster`, one process a
card) each shard belongs to one process (`Mesh.procs`): the cards are
numbered process-major, as `jax.devices()` orders them, and shard s sits
on global card s mod the card count. A process makes and holds only its
own shards' parts (a remote shard's slot is None, or absent from a
`{shard: value}` dict), and a group that spans processes fetches its
remote members' values through `torch.distributed` (one subgroup a set
of processes, made once when the mesh is built: `new_group` needs every
process to call it, in one order) before it runs the same group
function. So every process gets the single controller's bits: a
reduction is an all-gather of the members followed by the in-order sum,
min or max. GP moments and norms are small; an LM gradient, which is
large, is reduced by an all-to-all of the blocks each process holds
followed by the same in-order sum (`Sharded.settle`). Where work splits
over a group's ranks (tensor parallelism over the model axis, the MoE's
experts), `AxisGroup` runs a process's own ranks and its differentiable
collectives (`fanout`, `split`, `sum`, `gather`, `all_to_all`, and
sequence parallelism's `gather_fanout` and `sum_scatter`) move only
activations between them, every sum in rank order. A cache whose
sequence lies on the batch axes is read as its `Slices`, merged by a
group function over those axes (`over`).

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


def process_rank() -> tuple[int, int]:
    """(world size, this process's rank) of the `torch.distributed` group,
    (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def shard_owners(n_shards: int, processes: int, cards: int = 1) -> list[tuple[int, int]]:
    """(process, local card) of each shard: the processes' cards numbered
    process-major (`cards` a process), shard s on global card s mod the
    card count."""
    total = processes * cards
    return [divmod(s % total, cards) for s in range(n_shards)]


_GROUPS: dict = {}  # sorted process ranks -> their torch.distributed subgroup


def _subgroup(procs: tuple):
    """The process group of `procs` (None: the whole world), made on first
    use; every process must reach this in the same order (`Mesh` makes
    its groups when it is built)."""
    import torch.distributed as dist

    if len(procs) == dist.get_world_size():
        return None
    if procs not in _GROUPS:
        _GROUPS[procs] = dist.new_group(list(procs))
    return _GROUPS[procs]


class Mesh:
    """Named axes and one device per shard. Shards are numbered row-major
    over `axis_names` (the last axis fastest); `devices[s]` is shard s's
    device and `procs[s]` the process that holds it (every shard this
    process's unless `procs` is given). The home, where this process's
    global tensors live, is its first shard's device."""

    def __init__(self, shape: dict, devices, procs=None):
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
        world, self.process = process_rank()
        self.procs = (self.process,) * self.size if procs is None else tuple(procs)
        if len(self.procs) != self.size:
            raise ValueError(f"{len(self.procs)} owners for {self.size} shards")
        self.local = tuple(s for s in range(self.size) if self.procs[s] == self.process)
        if not self.local:
            raise ValueError(f"process {self.process} holds none of the {self.size} shards "
                             f"of {self.shape}")
        self.processes = tuple(sorted(set(self.procs)))
        self.multi = len(self.processes) > 1
        self._plans = {}
        if self.multi:
            if max(self.processes) >= world:
                raise ValueError(f"shards on processes {self.processes}, world size {world}")
            for axis in (*self.axis_names, batch_axes(self)):
                for group in self.groups(axis):
                    self.group_procs(group)
            self.group_procs(range(self.size))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    def is_local(self, s: int) -> bool:
        """Does this process hold shard `s`?"""
        return self.procs[s] == self.process

    def group_procs(self, group) -> tuple:
        """The processes holding the shards of `group`, sorted; their
        subgroup is made here the first time."""
        procs = tuple(sorted({self.procs[s] for s in group}))
        if len(procs) > 1:
            _subgroup(procs)
        return procs

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def home(self) -> torch.device:
        return self.devices[self.local[0]]

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
        """The shards that differ only in their rank along `axis` (a name,
        or a tuple of names: their combined rank, major first), one list
        per group in rank order (singletons for None or axes the mesh
        lacks), groups in the order of their first shard."""
        names = tuple(a for a in _names(axis) if a in self.shape)
        if not names:
            return [[s] for s in range(self.size)]
        out = {}
        for s in range(self.size):
            c = self.coords(s)
            out.setdefault(tuple(v for a, v in c.items() if a not in names), []).append(s)
        return [sorted(g, key=lambda s: self.batch_rank(s, names)) for g in out.values()]

    def batch_rank(self, s: int, axes) -> int:
        """Shard `s`'s combined rank along `axes` (major first)."""
        k, c = 0, self.coords(s)
        for a in _names(axes):
            k = k * self.axis_size(a) + c.get(a, 0)
        return k

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
        shard's device; None for a shard of another process."""
        t = torch.as_tensor(t)
        self.check(t.shape, spec)
        shards = range(self.size) if shards is None else shards
        return [t[self._block(s, t.shape, spec)].contiguous().to(self.devices[s])
                if self.is_local(s) else None for s in shards]

    def owners(self, spec) -> list[int]:
        """The shards that hold each block of a tensor under `spec` once:
        rank 0 on every axis the spec does not name, in shard order."""
        named = {a for part in spec for a in _names(part)}
        return [s for s in range(self.size)
                if all(r == 0 for a, r in self.coords(s).items() if a not in named)]

    def join(self, parts, spec, device=None, window=None):
        """The global tensor on `device` (default: the home device) from
        per-shard `parts` (a list over the shards, or a dict holding at
        least the shards read here; over several processes, every shard of
        this process): each block comes from the first shard that holds it,
        rank 0 on every axis the spec does not name. Over several
        processes it is a gather to every process: a block this process
        holds (a replica's copy is the same) is read here, the others come
        from their owners, with no host read.

        With `window` (axis, r), only the shards of rank r on `axis` are
        read: where the spec names a dimension by `axis` alone, the slice
        of that dimension rank r holds, else the whole tensor from rank
        r's replicas; over several processes their blocks come from the
        processes holding rank r, each of which joins it too (a gather
        over the other axes only)."""
        dev = self.home if device is None else torch.device(device)
        owners, procs = self.owners(spec), self.processes
        if window is not None:
            axis, r = window
            named = {a for part in spec for a in _names(part)}
            owners = [s for s in range(self.size) if self.rank(s, axis) == r and all(
                k == 0 for a, k in self.coords(s).items() if a not in named and a != axis)]
            procs = tuple(sorted({self.procs[s] for s in range(self.size)
                                  if self.rank(s, axis) == r}))
            spec = PartitionSpec(*(None if part == axis else part for part in spec))
        if self.multi:
            parts = self._gather_blocks(parts, spec, owners, procs)
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

    def axis_group(self, axis, s: int) -> "AxisGroup":
        """The group of `axis` holding shard `s`, as the ranks this process
        runs of it (`AxisGroup`): every rank in one process, its own ranks
        where the group spans processes."""
        group = next(g for g in self.groups(axis) if s in g)
        owners = tuple(self.procs[m] for m in group)
        key = ("axis_group", tuple(group))
        if key not in self._plans:
            if len(set(owners)) == 1:
                self._plans[key] = AxisGroup(len(group), members=group)
            else:
                self._plans[key] = AxisGroup(
                    len(group), [r for r, q in enumerate(owners) if q == self.process],
                    owners, self.process, members=group)
        return self._plans[key]

    def _holder(self, o: int, spec, procs=None):
        """A shard of process `procs` (default: this one) that holds owner
        `o`'s block under `spec`, or None."""
        named = {a for part in spec for a in _names(part)}
        co = self.coords(o)
        for s in range(self.size):
            if self.procs[s] == (self.process if procs is None else procs) and all(
                    self.coords(s)[a] == co[a] for a in named if a in co):
                return s
        return None

    def _gather_plan(self, spec, owners, procs) -> tuple:
        """({owner: this process's shard holding its block, or None}, does
        one of `procs` hold no copy of some block), from the layout alone,
        so every process takes the same decision."""
        key = (tuple(spec), tuple(owners))
        if key not in self._plans:
            self._plans[key] = (
                {o: self._holder(o, spec) for o in owners},
                any(self._holder(o, spec, q) is None for o in owners for q in procs))
        return self._plans[key]

    def _gather_blocks(self, parts, spec, owners, procs) -> dict:
        """{owner: its block} on this process: a local holder's part, or
        the owner's, fetched from its process among `procs` (the processes
        joining these blocks) when one of them holds no copy of a block."""
        get = parts.get if isinstance(parts, dict) else (lambda s: parts[s])
        local, fetch = self._gather_plan(spec, owners, procs)
        if not fetch:
            return {o: get(s) for o, s in local.items()}
        like = next(get(s) for s in self.local if get(s) is not None)
        got = exchange(self, owners, {o: get(o) for o in owners if self.is_local(o)},
                       like=like, procs=procs)
        return {o: get(s) if s is not None else got[o] for o, s in local.items()}


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, device=None) -> Mesh:
    """A mesh over the cards of `resolve_device(device)` (default: every
    card of the process; after `init_cluster`, the process's own card).
    Shard s goes to card s mod the card count, so one shard a card while
    there are cards enough, and the placement cycles where there are
    fewer cards than shards (8 shards on one card all share it, as the
    reference's fake host devices share one CPU). An indexed device
    (`cuda:1`) puts every shard on it; `device="cpu"` puts every shard on
    the CPU. Over several processes the cards are every process's, in
    process order (`shard_owners`), and a shard of another process is on
    the `meta` device here. Axes: ("pod", "data", "model") when pod > 1,
    else ("data", "model")."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    shape = {"pod": pod, "data": data, "model": model} if pod > 1 else {
        "data": data, "model": model}
    n = math.prod(shape.values())
    world, rank = process_rank()
    if world == 1:
        return Mesh(shape, [cards[s % len(cards)] for s in range(n)])
    owners = shard_owners(n, world, len(cards))
    return Mesh(shape, [cards[c] if q == rank else torch.device("meta") for q, c in owners],
                procs=[q for q, _ in owners])


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: (data 16, model 16), or with `multi_pod`
    (pod 2, data 16, model 16), its shards on the cards as
    `make_host_mesh` places them."""
    return make_host_mesh(data=16, model=16, pod=2 if multi_pod else 1, device=device)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# --- values across processes -------------------------------------------------------


def _flat(item) -> tuple[list, object]:
    """(the tensors of `item`, its structure): a tensor, or dicts, lists
    and tuples of tensors."""
    if isinstance(item, dict):
        keys = list(item)
        subs = [_flat(item[k]) for k in keys]
        return [t for ts, _ in subs for t in ts], ("dict", keys, [d for _, d in subs])
    if isinstance(item, (list, tuple)):
        subs = [_flat(v) for v in item]
        return [t for ts, _ in subs for t in ts], (type(item), [d for _, d in subs])
    return [item], None


def _unflat(it, tree):
    if tree is None:
        return next(it)
    if tree[0] == "dict":
        return {k: _unflat(it, d) for k, d in zip(tree[1], tree[2])}
    vals = [_unflat(it, d) for d in tree[1]]
    return tree[0](*vals) if hasattr(tree[0], "_fields") else tree[0](vals)


def _bytes(t) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def exchange(mesh: Mesh, group, values: dict, like=None, procs=None) -> dict:
    """Every member of `group`'s value on each process taking part, from
    each process's own: `values` holds this process's members of `group`
    (a tensor, or a dict/list/tuple of tensors, of one structure, shape
    and dtype across the members, as every shard's value is under SPMD);
    `like` gives that structure to a process that holds no member;
    `procs` are the processes taking part (default: the members'). One
    all-gather over their subgroup, of the members' values packed into
    bytes; members of one process stay as they are."""
    import torch.distributed as dist

    group = list(group)
    procs = mesh.group_procs(group) if procs is None else tuple(procs)
    me = mesh.process
    if procs == (me,):
        return dict(values)
    per = {q: [s for s in group if mesh.procs[s] == q] for q in procs}
    mine = per.get(me, [])
    leaves, tree = _flat(values[mine[0]] if mine else like)
    sizes = [_bytes(t).numel() for t in leaves]
    pads = [-n % 8 for n in sizes]  # each leaf 8-byte aligned in the row
    row = sum(sizes) + sum(pads)
    k = max(len(v) for v in per.values())
    dev = leaves[0].device
    buf = torch.zeros((k, row), dtype=torch.uint8, device=dev)
    for i, s in enumerate(mine):
        off = 0
        for t, n, pad in zip(_flat(values[s])[0], sizes, pads):
            buf[i, off:off + n] = _bytes(t)
            off += n + pad
    outs = [torch.empty_like(buf) for _ in procs]
    dist.all_gather(outs, buf, group=_subgroup(procs) if len(procs) > 1 else None)
    full = {}
    for q, out in zip(procs, outs):
        for i, s in enumerate(per[q]):
            if q == me:
                full[s] = values[s]
                continue
            got, off = [], 0
            for t, n, pad in zip(leaves, sizes, pads):
                seg = out[i, off:off + n]
                got.append(((seg != 0) if t.dtype == torch.bool else
                            seg.view(t.dtype)).reshape(t.shape))
                off += n + pad
            full[s] = _unflat(iter(got), tree)
    return full


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
    `parts` is a dict {shard: value} holding whole groups (over several
    processes: this process's shards of each group the first of `parts`
    names; an argument that holds every member, such as a flag made from
    the shard's coordinates, is taken as it is, the others' remote
    members are fetched with `exchange`). The result is a dict in the
    same form, this process's shards only, or a tuple of them where `fn`
    returns a tuple of lists."""
    outs, single = ({},), True
    for group in mesh.groups(axis):
        local = [s for s in group if mesh.is_local(s)]
        members = [s for s in local if s in parts[0]]
        if not members:
            continue
        if len(members) != len(local):
            raise ValueError(f"shards {members} are not the whole {axis!r} group {group}")
        args = [[p[s] for s in group] if all(s in p for s in group) else None for p in parts]
        fetch = [i for i, a in enumerate(args) if a is None]
        if fetch:
            got = exchange(mesh, group, {s: tuple(parts[i][s] for i in fetch) for s in local})
            for j, i in enumerate(fetch):
                args[i] = [got[s][j] for s in group]
        res = fn(*args, **kw)
        single = not isinstance(res, tuple)
        res = (res,) if single else res
        if len(outs) != len(res):
            outs = tuple({} for _ in res)
        for out, vals in zip(outs, res):
            out.update((s, v) for s, v in zip(group, vals) if s in members)
    return outs[0] if single else outs


# --- the ranks of one axis group, in one process or across several -------------------


def _from_bytes(seg, like) -> torch.Tensor:
    return seg.view(like.dtype).reshape(like.shape)


def _swap(procs, send: list, recv_sizes: list, device) -> list:
    """One `all_to_all_single` over the subgroup of `procs`: send[i] (a
    list of tensors, packed as bytes) goes to procs[i] -> the bytes from
    each process, recv_sizes[i] of them from procs[i]."""
    import torch.distributed as dist

    flat = [torch.cat([_bytes(t) for t in ts]) if ts else
            torch.empty(0, dtype=torch.uint8, device=device) for ts in send]
    recv = torch.empty(sum(recv_sizes), dtype=torch.uint8, device=device)
    dist.all_to_all_single(recv, torch.cat(flat), recv_sizes, [f.numel() for f in flat],
                           group=_subgroup(procs))
    return list(recv.split(recv_sizes))


class Blocks(list):
    """A tensor as its model ranks' blocks, one a rank a pass runs
    (`AxisGroup.ranks`), split along `dim`: a leaf the specs split over
    the model axis as a tensor-parallel pass reads it
    (`launch.sharding.gather_tree`, `ShardedCache.rows`, which take `dim`
    from the spec), and what a pass computes from such blocks. Code that
    takes a tensor whole or as blocks reads the split from `dim`."""

    def __init__(self, blocks, dim: int):
        super().__init__(blocks)
        self.dim = dim

    def map(self, fn, shift: int = 0) -> "Blocks":
        """`fn` of each block; `shift` where `fn` adds (+) or drops (-)
        leading dims."""
        return Blocks([fn(b) for b in self], self.dim + shift)


class Slices(list):
    """A cache leaf's sequence slices that this process holds, one a shard
    of `shards`, each the shard's part itself on its device: a leaf whose
    sequence the specs split over the batch axes (`axes`), as a decode
    pass reads it (`launch.sharding.ShardedCache.rows`) and writes it in
    place. `offsets` are the slices' first rows of the sequence, `length`
    the whole sequence's; the shards run in batch-rank order, and a group
    function over `axes` (`over`) merges what each slice computes. In a
    tensor-parallel pass a leaf the specs also split over the model axis
    comes as `Blocks` of one `Slices` a rank."""

    def __init__(self, parts, shards, offsets, length: int, mesh, axes):
        super().__init__(parts)
        self.shards, self.offsets, self.length = tuple(shards), tuple(offsets), length
        self.mesh, self.axes = mesh, axes

    def map(self, fn) -> "Slices":
        """`fn` of each slice (a group's view of a stacked leaf's)."""
        return Slices([fn(t) for t in self], self.shards, self.offsets, self.length,
                      self.mesh, self.axes)


class AxisGroup:
    """The ranks of one axis group (a data shard's model group) that this
    process runs, and differentiable collectives between them. Each
    collective takes and returns one value a rank this process runs
    (`ranks`, ascending; `members`, where the mesh made the group, are
    the shards of every rank). In one process `ranks` is every rank and
    the collectives are plain list functions; where the group spans
    processes (`owners`: each rank's process) a process runs its own ranks
    and the collectives cross the group's processes (`all_to_all_single`
    over their subgroup, of the tensors' bytes) with the same bits: they
    move data, and every sum (`sum`, `fanout`'s backward) adds every
    rank's term in rank order on every process.

    Tensor parallelism is built from four of them, Megatron's pairs: a
    replicated activation enters a rank's block through `fanout` (copies
    forward, the in-order sum of the ranks' gradients backward) or `split`
    (each rank its slice; the backward joins the slices), and leaves it
    through `sum` (a row-parallel product's partials added in rank order;
    the backward hands every rank the gradient) or `gather` (the ranks'
    blocks joined; the backward keeps each rank its own). Every rank of
    the group computes the replicated parts alike, so each process holds
    the whole gradient of a replicated tensor. Megatron's sequence
    parallelism keeps an activation as the ranks' rows between blocks:
    it enters through `gather_fanout` (the rows joined, a copy a rank;
    the backward a reduce-scatter) and leaves through `sum_scatter` (the
    partials added in rank order, each rank keeping its rows; the
    backward an all-gather)."""

    def __init__(self, size: int, ranks=None, owners=None, me: int = 0, members=None):
        self.size = size
        self.ranks = tuple(range(size)) if ranks is None else tuple(ranks)
        self.members = None if members is None else tuple(members)
        self.owners = owners
        self.spans = owners is not None
        if self.spans:
            self.me = me
            self.procs = tuple(sorted(set(owners)))
            self.of = {q: [r for r in range(size) if owners[r] == q] for q in self.procs}

    def __repr__(self):
        return f"AxisGroup(size={self.size}, ranks={self.ranks})"

    def split(self, x, dim: int) -> Blocks:
        """This process's ranks' slices of `x` (the same on every rank)
        along `dim`, rank r the r-th of `size`."""
        if not self.spans:
            return Blocks(torch.split(x, x.shape[dim] // self.size, dim), dim)
        return Blocks(_SplitOwn.apply(self, dim, x), dim)

    def gather(self, xs: list, dim: int):
        """Every rank's slice joined along `dim` in rank order (the same
        tensor on every rank)."""
        if not self.spans:
            return torch.cat(xs, dim)
        return _GatherCat.apply(self, dim, *xs)

    def sum(self, xs: list):
        """Every rank's partial added in rank order (the same tensor on
        every rank); the backward hands each rank the whole gradient."""
        if not self.spans:
            return self._reduce(xs)
        return _SumParts.apply(self, *xs)

    def sum_scatter(self, xs: list, dim: int) -> Blocks:
        """Every rank's partial added in rank order, each rank keeping its
        slice along `dim` (rank r the r-th of `size`): bitwise `sum(xs)`
        split along `dim`. The backward hands each rank the gradient
        joined from every rank's slice. Over processes a process receives
        (size - 1) / size of a partial a rank (`_scatter`), half of
        `sum`'s."""
        if not self.spans:
            total = self._reduce(xs)
            return Blocks(torch.split(total, total.shape[dim] // self.size, dim), dim)
        return Blocks(_SumScatter.apply(self, dim, *xs), dim)

    def gather_fanout(self, xs: list, dim: int):
        """(every rank's slice joined along `dim`, that tensor for each rank
        this process runs): `gather` then `fanout` in one step. The first
        serves what every rank computes alike, the copies what each rank
        computes with its own block. The backward adds the copies'
        gradients in rank order, then the first's, and hands each rank its
        slice: over processes a reduce-scatter (`_scatter`), as
        `sum_scatter`'s forward. Outside autograd's recording the copies
        are the joined tensor itself."""
        if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
            whole = self.gather(xs, dim)
            return whole, [whole] * len(self.ranks)
        out = _GatherFanout.apply(self, dim, *xs)
        return out[0], list(out[1:])

    def fanout(self, w) -> list:
        """`w` (the same on every rank) for each rank this process runs;
        the gradients of every rank add up into `w`'s in rank order.
        Outside autograd's recording it is `w` itself for each rank."""
        if not (torch.is_grad_enabled() and w.requires_grad):
            return [w] * len(self.ranks)
        return list(_Fanout.apply(self, w))

    def all_to_all(self, xs: list, split_dim: int, concat_dim: int) -> list:
        """`all_to_all` (tiled) over the group: rank r's chunk j goes to
        rank j, which joins what it gets along `concat_dim` in rank order;
        the backward is the reverse all-to-all."""
        if not self.spans:
            return all_to_all(xs, split_dim, concat_dim)
        return list(_AllToAll.apply(self, split_dim, concat_dim, *xs))

    def every(self, xs: list) -> list:
        """Every rank's value in rank order, from this process's ranks'
        (the backward keeps each rank its own value's gradient)."""
        if not self.spans:
            return list(xs)
        return list(self.gather([x.unsqueeze(0) for x in xs], 0).unbind(0))

    # the collectives' data movement, outside autograd

    def _every(self, xs: list) -> list:
        if not self.spans:
            return list(xs)
        like = xs[0]
        n = _bytes(like).numel()
        got = _swap(self.procs, [[] if q == self.me else list(xs) for q in self.procs],
                    [0 if q == self.me else len(self.of[q]) * n for q in self.procs],
                    like.device)
        out = [None] * self.size
        for q, buf in zip(self.procs, got):
            for i, r in enumerate(self.of[q]):
                out[r] = (xs[self.ranks.index(r)] if q == self.me else
                          _from_bytes(buf[i * n:(i + 1) * n], like))
        return out

    def _reduce(self, xs: list):
        """The sum of every rank's `xs` (this process's ranks' given) in
        rank order, on every process. Over processes each partial is cut
        into `size` chunks and rank j's process adds up chunk j of every
        rank in rank order (one all-to-all), then the sums are gathered
        (another): each element is added in the single controller's
        order, and a process receives 2 (size - 1) / size of a partial
        a rank instead of size - 1."""
        if not self.spans:
            total = xs[0]
            for x in xs[1:]:
                total = total + x.to(total.device)
            return total
        like, n = xs[0], xs[0].numel()
        c = -(-n // self.size)
        flat = {r: torch.nn.functional.pad(x.reshape(-1), (0, c * self.size - n)).view(
            self.size, c) for r, x in zip(self.ranks, xs)}
        row = flat[self.ranks[0]][0]
        nb = c * like.element_size()
        got = _swap(self.procs, [[] if q == self.me else [flat[r][j] for r in self.ranks
                                                          for j in self.of[q]]
                                 for q in self.procs],
                    [0 if q == self.me else len(self.of[q]) * len(self.ranks) * nb
                     for q in self.procs], like.device)
        chunk = {(r, j): flat[r][j] for r in self.ranks for j in self.ranks}
        for q, buf in zip(self.procs, got):
            if q == self.me:
                continue
            k = 0
            for r in self.of[q]:
                for j in self.ranks:
                    chunk[r, j] = _from_bytes(buf[k * nb:(k + 1) * nb], row)
                    k += 1
        sums = {}
        for j in self.ranks:
            total = chunk[0, j]
            for r in range(1, self.size):
                total = total + chunk[r, j]
            sums[j] = total
        got = _swap(self.procs, [[] if q == self.me else [sums[j] for j in self.ranks]
                                 for q in self.procs],
                    [0 if q == self.me else len(self.of[q]) * nb for q in self.procs],
                    like.device)
        for q, buf in zip(self.procs, got):
            if q != self.me:
                for i, j in enumerate(self.of[q]):
                    sums[j] = _from_bytes(buf[i * nb:(i + 1) * nb], row)
        return torch.cat([sums[j] for j in range(self.size)])[:n].view(like.shape)

    def _route(self, xs: list, dim: int) -> dict:
        """{(r, j): chunk j of rank r's x along `dim`} for every rank r and
        each rank j this process runs: one all-to-all, chunk j of each of
        this process's ranks to rank j's process."""
        chunks = {r: x.chunk(self.size, dim) for r, x in zip(self.ranks, xs)}
        like = chunks[self.ranks[0]][0]
        n = like.numel() * like.element_size()
        send = [[] if q == self.me else [chunks[r][j] for r in self.ranks for j in self.of[q]]
                for q in self.procs]
        got = _swap(self.procs, send, [0 if q == self.me else
                                       len(self.of[q]) * len(self.ranks) * n
                                       for q in self.procs], like.device)
        recv = {(r, j): chunks[r][j] for r in self.ranks for j in self.ranks}
        for q, buf in zip(self.procs, got):
            if q == self.me:
                continue
            k = 0
            for r in self.of[q]:
                for j in self.ranks:
                    recv[r, j] = _from_bytes(buf[k * n:(k + 1) * n], like)
                    k += 1
        return recv

    def _all_to_all(self, xs: list, split_dim: int, concat_dim: int) -> list:
        recv = self._route(xs, split_dim)
        return [torch.cat([recv[r, j] for r in range(self.size)], concat_dim)
                for j in self.ranks]

    def _scatter(self, xs: list, dim: int) -> list:
        """For each rank j this process runs, chunk j along `dim` of every
        rank's `xs` added in rank order: `_reduce`'s first all-to-all,
        cut along `dim`."""
        recv = self._route(xs, dim)
        out = []
        for j in self.ranks:
            total = recv[0, j]
            for r in range(1, self.size):
                total = total + recv[r, j]
            out.append(total)
        return out


def _filled(grads) -> list:
    """The gradients of outputs of one shape, zeros for those unused."""
    like = next(t for t in grads if t is not None)
    return [torch.zeros_like(like) if t is None else t for t in grads]


class _SplitOwn(torch.autograd.Function):
    """`AxisGroup.split` across processes."""

    @staticmethod
    def forward(ctx, g, dim, x):
        n = x.shape[dim] // g.size
        ctx.g, ctx.dim = g, dim
        return tuple(x.narrow(dim, r * n, n).clone(memory_format=torch.contiguous_format)
                     for r in g.ranks)

    @staticmethod
    def backward(ctx, *grads):
        return None, None, torch.cat(ctx.g._every(_filled(grads)), ctx.dim)


class _GatherCat(torch.autograd.Function):
    """`AxisGroup.gather` across processes."""

    @staticmethod
    def forward(ctx, g, dim, *xs):
        ctx.g, ctx.dim, ctx.n = g, dim, xs[0].shape[dim]
        return torch.cat(g._every(xs), dim)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.n
        return (None, None, *(grad.narrow(ctx.dim, r * n, n) for r in ctx.g.ranks))


class _SumParts(torch.autograd.Function):
    """`AxisGroup.sum` across processes: the in-order sum forward, the
    gradient to every rank backward."""

    @staticmethod
    def forward(ctx, g, *xs):
        ctx.n = len(xs)
        return g._reduce(list(xs))

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad for _ in range(ctx.n)))


class _SumScatter(torch.autograd.Function):
    """`AxisGroup.sum_scatter` across processes: the reduce-scatter
    forward, every rank's slice of the gradient joined backward."""

    @staticmethod
    def forward(ctx, g, dim, *xs):
        ctx.g, ctx.dim, ctx.n = g, dim, len(xs)
        return tuple(g._scatter(list(xs), dim))

    @staticmethod
    def backward(ctx, *grads):
        full = torch.cat(ctx.g._every(_filled(grads)), ctx.dim)
        return (None, None, *(full for _ in range(ctx.n)))


class _GatherFanout(torch.autograd.Function):
    """`AxisGroup.gather_fanout`: the slices joined and copied forward;
    backward, the copies' gradients added in rank order (a reduce-scatter
    over processes), then the joined tensor's, each rank its slice."""

    @staticmethod
    def forward(ctx, g, dim, *xs):
        ctx.g, ctx.dim, ctx.n = g, dim, xs[0].shape[dim]
        whole = torch.cat(g._every(list(xs)), dim)
        return (whole, *(whole.clone() for _ in g.ranks))

    @staticmethod
    def backward(ctx, grad, *grads):
        g, dim, n = ctx.g, ctx.dim, ctx.n
        if all(t is None for t in grads):
            per = [grad.narrow(dim, r * n, n) for r in g.ranks]
        else:
            if g.spans:
                per = g._scatter(_filled(grads), dim)
            else:
                per = list(torch.split(g._reduce(_filled(grads)), n, dim))
            if grad is not None:
                per = [t + grad.narrow(dim, r * n, n) for t, r in zip(per, g.ranks)]
        return (None, None, *per)


class _Fanout(torch.autograd.Function):
    """`AxisGroup.fanout`: copies forward, the in-order sum of every
    rank's gradient backward."""

    @staticmethod
    def forward(ctx, g, w):
        ctx.g = g
        return tuple(w.clone() for _ in g.ranks)

    @staticmethod
    def backward(ctx, *grads):
        return None, ctx.g._reduce(_filled(grads))


class _AllToAll(torch.autograd.Function):
    """`AxisGroup.all_to_all` across processes."""

    @staticmethod
    def forward(ctx, g, split_dim, concat_dim, *xs):
        ctx.args = (g, split_dim, concat_dim)
        return tuple(g._all_to_all(xs, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *grads):
        g, split_dim, concat_dim = ctx.args
        return (None, None, None, *g._all_to_all(_filled(grads), concat_dim, split_dim))


# --- a tensor stored as per-shard parts ----------------------------------------


class _Gather(torch.autograd.Function):
    """The global tensor from a `Sharded`'s parts; the backward hands each
    part its block of the gradient (every shard that holds a block, the
    replicas too), so gradients of several gathers add up in the parts:
    the all-gather's transpose, a reduce-scatter. Over several processes
    a gather for pass `key` (a data shard's rows, `Sharded.gather`) keeps
    the blocks of the pass's gradient that `Sharded.settle` reads instead
    (`Sharded._kept`), and the settle adds the passes' into the parts in
    pass order once every process has run its own."""

    @staticmethod
    def forward(ctx, sh, device, key, window, *local):
        # a window on an axis the spec does not name reads rank r's
        # replicas; the gradient goes to every replica, as without one
        ctx.sh, ctx.key = sh, key
        ctx.window = window if window is not None and sh.names(window[0]) else None
        return sh.mesh.join(sh.parts, sh.spec, device, window)

    @staticmethod
    def backward(ctx, grad):
        sh, window = ctx.sh, ctx.window
        local = [s for s in sh.mesh.local]
        if ctx.key is not None:
            kept = sh.pending.setdefault(ctx.key, {})
            for b, blk in sh._kept(ctx.key, window):
                kept[b] = grad[blk].clone() if b not in kept else kept[b] + grad[blk]
            return (None, None, None, None, *(None for _ in local))
        return (None, None, None, None, *(
            None if not sh.in_window(s, window) else
            grad[sh.block(s, window)].to(sh.parts[s].device, copy=True).contiguous()
            for s in local))


class Sharded:
    """A global tensor of `shape` stored as one part per shard of `mesh`,
    split by `spec` (`Mesh.split`); shards that hold the same block (the
    axes the spec does not name) keep copies of it, as the devices of a
    mesh do. `join` is the global tensor, `gather` the same as a step of
    autograd's graph, `assign` writes a global value into the parts. Over
    several processes a part of another process is None."""

    def __init__(self, mesh: Mesh, spec, parts: list, shape):
        self.mesh, self.spec, self.parts = mesh, PartitionSpec(*spec), list(parts)
        self.shape = torch.Size(shape)
        self.pending = {}  # pass -> {block: its gradient's block} (`settle`)
        self._keeps = {}

    @classmethod
    def place(cls, mesh: Mesh, t, spec) -> "Sharded":
        """`t`'s parts under `spec`, each a tensor of its own on its
        shard's device (no part aliases `t` or another part)."""
        t = torch.as_tensor(t)
        spec = PartitionSpec(*spec)
        mesh.check(t.shape, spec)
        parts = [None] * mesh.size
        for s in mesh.local:
            block = t[mesh._block(s, t.shape, spec)]
            parts[s] = torch.empty(block.shape, dtype=t.dtype,
                                   device=mesh.devices[s]).copy_(block)
        return cls(mesh, spec, parts, t.shape)

    @classmethod
    def zeros(cls, mesh: Mesh, spec, shape, dtype=torch.float32) -> "Sharded":
        spec = PartitionSpec(*spec)
        shape = torch.Size(shape)
        mesh.check(shape, spec)
        parts = [None] * mesh.size
        for s in mesh.local:
            parts[s] = torch.zeros([b.stop - b.start for b in mesh._block(s, shape, spec)],
                                   dtype=dtype, device=mesh.devices[s])
        return cls(mesh, spec, parts, shape)

    def __repr__(self):
        return f"Sharded({tuple(self.shape)}, {self.spec!r}, {self.mesh.shape})"

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[self.mesh.local[0]].dtype

    def local(self) -> list:
        """This process's parts, in shard order."""
        return [self.parts[s] for s in self.mesh.local]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def block(self, s: int, window=None) -> tuple:
        """Shard `s`'s slices of the global tensor, or of its `window`
        (`Mesh.join`'s (axis, rank) slice)."""
        if window is None:
            return self.mesh._block(s, self.shape, self.spec)
        axis = window[0]
        shape = [n // self.mesh.axis_size(axis) if part == axis else n
                 for n, part in zip(self.shape, (*self.spec, *[None] * self.ndim))]
        return self.mesh._block(s, shape, P(*(None if part == axis else part
                                               for part in self.spec)))

    def names(self, axis) -> bool:
        """Does the spec split a dimension over `axis`?"""
        return any(axis in _names(part) for part in self.spec)

    def window_shape(self, window=None) -> tuple:
        """The shape of the global tensor's `window` (`Mesh.join`)."""
        if window is None:
            return tuple(self.shape)
        return tuple(n // self.mesh.axis_size(window[0]) if part == window[0] else n
                     for n, part in zip(self.shape, (*self.spec, *[None] * self.ndim)))

    def in_window(self, s: int, window) -> bool:
        return window is None or self.mesh.rank(s, window[0]) == window[1]

    def owners(self) -> list[int]:
        return self.mesh.owners(self.spec)

    def join(self, device=None) -> torch.Tensor:
        return self.mesh.join([None if p is None else p.detach() for p in self.parts],
                              self.spec, device)

    def gather(self, device=None, key=None, window=None) -> torch.Tensor:
        """The global tensor on `device`, or its `window` (`Mesh.join`:
        rank r's slice where the spec names the window's axis, else the
        whole tensor read from rank r's replicas), differentiable in the
        parts. On a mesh of several processes `key` names the pass (a
        batch rank) the gather serves: its gradient waits for `settle`."""
        dev = self.mesh.home if device is None else torch.device(device)
        local = self.local()
        if any(p.requires_grad for p in local) and torch.is_grad_enabled():
            return _Gather.apply(self, dev, key if self.mesh.multi else None, window, *local)
        return self.mesh.join(self.parts, self.spec, dev, window)

    def settle(self, axes) -> None:
        """Add the gradients the passes kept (`gather` with a key, one pass
        a rank along the batch `axes`) into the local parts' `.grad`, pass
        after pass in rank order, as one process adds each pass's backward
        in turn: the reduce-scatter over the processes, each process
        sending each other process only the blocks of its passes'
        gradients that process's parts hold (`_swap_blocks`), then the
        in-order sum. Every process calls it for the same tensors in one
        order."""
        if not self.pending:
            return
        for group in self.mesh.groups(axes):
            local = [s for s in group if self.mesh.is_local(s)]
            if not local:
                continue
            got = self._swap_blocks(group, local, axes)
            for s in local:
                p = self.parts[s]
                g = p.grad
                for m in group:
                    add = got[m, s].to(p.device)
                    g = add.clone() if g is None else g + add
                p.grad = g
        self.pending = {}

    def _kept(self, key, window=None) -> list:
        """[(block key, slices)] of pass `key`'s gradient that `settle`
        reads here: every shard's block in each batch group where this
        process holds a shard of batch rank `key` (those in `window`, the
        slices in its coordinates, for a gather of a window)."""
        if (key, window) not in self._keeps:
            mesh, axes = self.mesh, batch_axes(self.mesh)
            out = {}
            for group in mesh.groups(axes):
                if any(mesh.is_local(m) and mesh.batch_rank(m, axes) == key for m in group):
                    for s in group:
                        if self.in_window(s, window):
                            out.setdefault(tuple((b.start, b.stop) for b in self.block(s)),
                                           self.block(s, window))
            self._keeps[key, window] = list(out.items())
        return self._keeps[key, window]

    def _swap_blocks(self, group, local, axes) -> dict:
        """{(member m, local shard s): m's pass gradient's block of s} for
        the members of a batch group: the local members' blocks sliced
        here, the others' from one all-to-all over the group's processes,
        in which a process sends each other process, member after member
        of its own, the blocks of that process's shards."""
        import torch.distributed as dist

        mesh, me = self.mesh, self.mesh.process

        def blocks(m, shards):
            g = self.pending[mesh.batch_rank(m, axes)]
            return [g[tuple((b.start, b.stop) for b in self.block(s))] for s in shards]

        got = {(m, s): b for m in local for s, b in zip(local, blocks(m, local))}
        procs = mesh.group_procs(group)
        if len(procs) == 1:
            return got
        per = {q: [s for s in group if mesh.procs[s] == q] for q in procs}
        like = got[local[0], local[0]]
        n = like.numel()
        send = torch.cat([b.reshape(-1) for q in procs if q != me
                          for m in local for b in blocks(m, per[q])])
        sizes_in = [0 if q == me else len(local) * len(per[q]) * n for q in procs]
        sizes_out = [0 if q == me else len(per[q]) * len(local) * n for q in procs]
        recv = send.new_empty(sum(sizes_out))
        dist.all_to_all_single(recv, send, sizes_out, sizes_in,
                               group=_subgroup(procs))
        off = 0
        for q in procs:
            for m in (per[q] if q != me else ()):
                for s in local:
                    got[m, s] = recv[off:off + n].view(like.shape)
                    off += n
        return got

    def assign(self, value) -> None:
        """Write the global tensor `value` into every part, in place."""
        with torch.no_grad():
            for s in self.mesh.local:
                self.parts[s].copy_(value[self.block(s)])

    def with_parts(self, parts: list) -> "Sharded":
        """Another tensor of this layout (a gradient, a moment) from `parts`."""
        return Sharded(self.mesh, self.spec, parts, self.shape)
