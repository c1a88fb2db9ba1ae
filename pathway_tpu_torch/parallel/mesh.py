"""Device meshes, sharded tensors and the collectives over them
(counterpart of ``pathway_tpu/parallel/mesh.py``).

The mesh is single-controller, as JAX's: one process drives every mesh
position. A :class:`Mesh` is a list of ``torch.device``s reshaped to named
axes, ``("dp", "tp")`` for :func:`make_mesh` and ``("data", "fsdp",
"tp")`` for :func:`make_serving_mesh`. The list may name one device more
than once: each position is then a virtual shard on that device, the
port's counterpart of JAX's ``--xla_force_host_platform_device_count``
(tests pass ``[cpu] * 8``, the card's smoke run ``[cuda:0] * 8``).

A :class:`ShardedTensor` holds one contiguous tensor per mesh position,
its :class:`PartitionSpec` and its global shape; positions that share a
device and a slice share one tensor. Torch ops on it run once per
distinct shard (``shard_map`` with no collective), so code written for
one device runs unchanged on a tensor sharded along a dim it never mixes.
:func:`all_gather` and :func:`all_reduce_sum` move shards with
``.to(device)`` (a peer copy between cards, nothing on a repeated device)
and sum in a fixed order, shard 0 first.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DATA_AXIS = "dp"
TENSOR_AXIS = "tp"

SERVE_DATA_AXIS = "data"
SERVE_FSDP_AXIS = "fsdp"
SERVE_TP_AXIS = "tp"
SERVE_AXES = (SERVE_DATA_AXIS, SERVE_FSDP_AXIS, SERVE_TP_AXIS)


class PartitionSpec(tuple):
    """Per-dim mesh axes: ``None`` (replicated), an axis name, or a tuple
    of names (the dim splits over their product, first name outermost).
    Missing trailing dims are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """Named axes over a row-major list of devices (repeats allowed)."""

    def __init__(self, devices, shape, axis_names):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh shape {tuple(shape)} != {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, p: int) -> dict:
        """Axis -> coordinate of mesh position ``p`` (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            p, out[a] = divmod(p, self.shape[a])
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.shape == other.shape)

    def __hash__(self) -> int:
        return hash((tuple(str(d) for d in self.devices),
                     tuple(self.shape.items())))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


def _devices(devices) -> list:
    """The given devices, or every visible CUDA device (raises without)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over devices=None spans the visible CUDA devices and none "
            "is available; pass devices=[...] (e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_axis() -> str:
    return DATA_AXIS


def tensor_axis() -> str:
    return TENSOR_AXIS


def make_mesh(devices=None, dp: int | None = None, tp: int = 1) -> Mesh:
    """A ``(dp, tp)`` mesh over the given devices (default: all CUDA)."""
    devices = _devices(devices)
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    return Mesh(devices, (dp, tp), (DATA_AXIS, TENSOR_AXIS))


def local_mesh() -> Mesh:
    """The 1-card degenerate mesh."""
    return make_mesh(_devices(None)[:1], dp=1, tp=1)


def shard_batch(mesh: Mesh, *axes_rest: int) -> NamedSharding:
    """Sharding of an array whose leading dim is the batch (over dp)."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * len(axes_rest))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class MeshShapeError(ValueError):
    """An impossible serving-mesh shape, raised on the host before anything
    is placed. Carries the requested axis lengths and the device count."""

    def __init__(self, msg: str, *, data: int, fsdp: int, tp: int, n_devices: int):
        super().__init__(
            f"{msg} (requested data={data} fsdp={fsdp} tp={tp} over "
            f"{n_devices} devices)")
        self.data = data
        self.fsdp = fsdp
        self.tp = tp
        self.n_devices = n_devices


def mesh_shape_error(msg: str, mesh: Mesh) -> MeshShapeError:
    """A :class:`MeshShapeError` about ``mesh`` as it stands."""
    return MeshShapeError(msg, data=int(mesh.shape.get(SERVE_DATA_AXIS, 1)),
                          fsdp=int(mesh.shape.get(SERVE_FSDP_AXIS, 1)),
                          tp=int(mesh.shape.get(SERVE_TP_AXIS, 1)),
                          n_devices=mesh.size)


def make_serving_mesh(devices=None, *, data: int = 1, fsdp: int = 1,
                      tp: int = 0) -> Mesh:
    """The ``(data, fsdp, tp)`` serving mesh over the given devices
    (default: all CUDA). ``tp=0`` takes every device left after
    ``data * fsdp``. Impossible shapes raise :class:`MeshShapeError`."""
    devices = _devices(devices)
    n = len(devices)
    data, fsdp, tp = int(data), int(fsdp), int(tp)
    if data < 1 or fsdp < 1 or tp < 0:
        raise MeshShapeError("serving-mesh axis lengths must be positive",
                             data=data, fsdp=fsdp, tp=tp, n_devices=n)
    if tp == 0:
        if n % (data * fsdp) != 0:
            raise MeshShapeError(
                f"data*fsdp={data * fsdp} does not divide the device count, so "
                "tp cannot be inferred", data=data, fsdp=fsdp, tp=tp, n_devices=n)
        tp = n // (data * fsdp)
    if data * fsdp * tp != n:
        raise MeshShapeError(f"data*fsdp*tp={data * fsdp * tp} != device count",
                             data=data, fsdp=fsdp, tp=tp, n_devices=n)
    return Mesh(devices, (data, fsdp, tp), SERVE_AXES)


def mesh_is_trivial(mesh: Mesh | None) -> bool:
    """True for no mesh or a one-position mesh: placement is then plain
    single-device placement and the byte-identity pin applies."""
    return mesh is None or mesh.size == 1


def _axes(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_with_fsdp(spec, shape: tuple, fsdp: int, axis: str = SERVE_FSDP_AXIS):
    """Overlay ``axis`` onto ``spec``'s first unsharded dim that ``fsdp``
    divides (ZeRO-3 remainder sharding); unchanged when ``fsdp == 1`` or
    no dim divides."""
    if fsdp <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % fsdp == 0 and d > 0:
            parts[i] = axis
            return P(*parts)
    return spec


def spec_dropping_nondividing(spec, shape: tuple, mesh: Mesh):
    """``spec`` with every axis dropped from the dims it does not divide
    (those dims replicate): the lenient placement of modules that shard
    what divides and replicate the rest."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for p, d in zip(parts, shape):
        if p is None:
            out.append(None)
            continue
        size = math.prod(int(mesh.shape.get(a, 1)) for a in _axes(p))
        out.append(p if size > 0 and d % size == 0 else None)
    return P(*out)


def _box(mesh: Mesh, spec, shape: tuple, p: int) -> tuple:
    """The slice of the global tensor mesh position ``p`` holds: one
    ``(start, length)`` a dim."""
    c = mesh.coords(p)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    box = []
    for part, d in zip(parts, shape):
        n, idx = 1, 0
        for a in _axes(part):
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + c[a]
        if d % n:
            raise mesh_shape_error(f"dim {d} does not split {n} ways under {spec!r}", mesh)
        box.append((idx * (d // n), d // n))
    return tuple(box)


def _narrow(t: torch.Tensor, box) -> torch.Tensor:
    for dim, (s, n) in enumerate(box):
        if n != t.shape[dim]:
            t = t.narrow(dim, s, n)
    return t


def _map_tree(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tree(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map_tree(fn, v) for k, v in x.items()}
    return fn(x)


def _find_sharded(x, out: list) -> list:
    if isinstance(x, ShardedTensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _find_sharded(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _find_sharded(v, out)
    return out


class ShardedTensor:
    """One tensor per mesh position (``shards[index[p]]``), with the spec
    and global shape it was placed with (``None`` for a value derived by a
    per-shard op). ``shape`` / ``dtype`` / ``device`` are the local
    shard's; torch functions, methods, indexing and arithmetic run per
    distinct shard and return a :class:`ShardedTensor` of the same layout
    (plain tensors among the operands are used as they are on every shard,
    moved to the shard's device). Values that are not tensors come from
    shard 0."""

    def __init__(self, shards, index, mesh: Mesh, spec=None, shape=None):
        object.__setattr__(self, "shards", list(shards))
        object.__setattr__(self, "index", tuple(index))
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "global_shape", None if shape is None else tuple(shape))

    # -- placement ---------------------------------------------------------

    @classmethod
    def place(cls, t: torch.Tensor, mesh: Mesh, spec, *, share: bool = True) -> "ShardedTensor":
        """Split ``t`` by ``spec`` over ``mesh``: each distinct (device,
        slice) becomes its own contiguous tensor on that device. With
        ``share=False`` every position gets its own tensor, as positions on
        distinct cards would, though several sit on one device (how the
        tests and the card's smoke run keep dp replicas apart). The shards
        are new leaves: ``t``'s autograd history is not carried."""
        spec = P(*spec)
        t = t.detach()
        shards, index, seen = [], [], {}
        for p, dev in enumerate(mesh.devices):
            box = _box(mesh, spec, tuple(t.shape), p)
            key = (str(dev), box) if share else p
            if key not in seen:
                seen[key] = len(shards)
                shards.append(_narrow(t, box).to(dev).clone(
                    memory_format=torch.contiguous_format))
            index.append(seen[key])
        return cls(shards, index, mesh, spec, t.shape)

    def _assemble(self, positions, box) -> torch.Tensor:
        """The ``box`` of the global tensor, from the shards of
        ``positions``. Differentiable: each distinct shard among them gets
        the gradient of its own box (a box's replicas each the same)."""
        js, boxes = [], []
        for p in positions:
            j = self.index[p]
            if j not in js:
                js.append(j)
                pbox = _box(self.mesh, self.spec, self.global_shape, p)
                boxes.append(tuple((s - s0, n) for (s, n), (s0, _) in zip(pbox, box)))
        return _Assemble.apply(tuple(boxes), tuple(n for _, n in box), self.device,
                               *(self.shards[j] for j in js))

    def gather(self) -> torch.Tensor:
        """The global tensor, on shard 0's device."""
        if self.spec is None:
            raise ValueError("gather() needs the placement spec; this value was "
                             "derived per shard (use all_gather on its shards)")
        return self._assemble(range(self.mesh.size),
                              tuple((0, d) for d in self.global_shape))

    def local(self, axis: str, i: int) -> torch.Tensor:
        """The tensor mesh coordinate ``axis == i`` holds once every other
        axis is gathered (ZeRO-3's gather on use), on that coordinate's
        first device. ``axis`` must shard a dim alone, if at all."""
        ps = [p for p in range(self.mesh.size) if self.mesh.coords(p)[axis] == i]
        n = self.mesh.shape[axis]
        parts = list(self.spec) + [None] * (len(self.global_shape) - len(self.spec))
        box = []
        for part, d in zip(parts, self.global_shape):
            axes = _axes(part)
            if axis not in axes:
                box.append((0, d))
            elif axes == (axis,):
                box.append((i * (d // n), d // n))
            else:
                raise ValueError(f"local() needs {axis!r} alone on its dim, got {self.spec!r}")
        return self._assemble(ps, tuple(box)).to(self.mesh.devices[ps[0]])

    def position_bytes(self) -> dict[str, int]:
        """Bytes each mesh position holds, keyed ``"0"``..``str(size-1)``."""
        return {str(p): self.shards[i].numel() * self.shards[i].element_size()
                for p, i in enumerate(self.index)}

    def numel(self) -> int:
        """Elements over the distinct shards (the global count for a tensor
        sharded along one axis and replicated on a shared device)."""
        return sum(s.numel() for s in self.shards)

    # -- local attributes ----------------------------------------------------

    @property
    def shape(self):
        return self.shards[0].shape

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self) -> str:
        return (f"ShardedTensor(local={tuple(self.shape)}, global={self.global_shape}, "
                f"spec={self.spec!r}, shards={len(self.shards)}, dtype={self.dtype})")

    # -- per-shard execution ---------------------------------------------------

    @classmethod
    def map(cls, fn, *args, **kwargs):
        """``fn`` once per distinct shard of the sharded operands (which
        must share one layout); plain operands pass to every call."""
        sharded = _find_sharded((args, kwargs), [])
        if not sharded:
            return fn(*args, **kwargs)
        lead = sharded[0]
        for s in sharded[1:]:
            if s.index != lead.index:
                raise ValueError("per-shard op over tensors of different layouts")
        outs = []
        for j, shard in enumerate(lead.shards):
            dev = shard.device

            def pick(x, j=j, dev=dev):
                if isinstance(x, ShardedTensor):
                    return x.shards[j]
                if isinstance(x, torch.Tensor) and x.device != dev and x.dim() > 0:
                    return x.to(dev)
                return x

            outs.append(fn(*_map_tree(pick, args), **_map_tree(pick, kwargs)))
        return _rewrap(outs, lead)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return cls.map(func, *args, **(kwargs or {}))

    def __getattr__(self, name):
        attr = getattr(self.shards[0], name)
        if not callable(attr):
            return attr
        return lambda *a, **k: ShardedTensor.map(
            lambda s, *aa, **kk: getattr(s, name)(*aa, **kk), self, *a, **k)

    def __setattr__(self, name, value):
        raise AttributeError(f"ShardedTensor is read-only ({name})")

    def __getitem__(self, idx):
        return ShardedTensor.map(lambda s, i: s[i], self, idx)

    def __setitem__(self, idx, value):
        ShardedTensor.map(lambda s, i, v: s.__setitem__(i, v), self, idx, value)

    def __bool__(self):
        raise TypeError("the truth value of a ShardedTensor is per shard")

    __hash__ = object.__hash__


class _Assemble(torch.autograd.Function):
    """Shards copied into one tensor; each box from the first shard that
    holds it. The backward hands every shard the gradient of its box."""

    @staticmethod
    def forward(ctx, boxes, shape, device, *shards):
        out = torch.empty(shape, dtype=shards[0].dtype, device=device)
        done = set()
        for box, shard in zip(boxes, shards):
            if box not in done:
                done.add(box)
                _narrow(out, box).copy_(shard.to(device))
        ctx.boxes = boxes
        ctx.devices = [t.device for t in shards]
        return out

    @staticmethod
    def backward(ctx, grad):
        return (None, None, None, *(_narrow(grad, box).to(dev).contiguous()
                                    for box, dev in zip(ctx.boxes, ctx.devices)))


def reduce_replica_grads(tree, axis: str = DATA_AXIS) -> None:
    """GSPMD's gradient all-reduce over ``axis`` for every sharded leaf of a
    nested dict, after a backward in which each ``axis`` replica computed
    on its share of the batch (through :meth:`ShardedTensor.local`): the
    positions that differ only in their ``axis`` coordinate hold one box,
    and each of their distinct shards gets the sum of their gradients (in
    position order), so an optimiser step keeps the replicas bitwise
    equal. A shard shared by several positions (one device, one box)
    already summed their gradients in autograd and is counted once."""
    if isinstance(tree, dict):
        for v in tree.values():
            reduce_replica_grads(v, axis)
        return
    if not isinstance(tree, ShardedTensor):
        return
    mesh = tree.mesh
    groups: dict = {}
    for p in range(mesh.size):
        key = tuple(v for a, v in mesh.coords(p).items() if a != axis)
        js = groups.setdefault(key, [])
        if tree.index[p] not in js:
            js.append(tree.index[p])
    for js in groups.values():
        grads = [tree.shards[j].grad for j in js]
        if len(js) < 2 or all(g is None for g in grads):
            continue
        dev = tree.shards[js[0]].device
        total = None
        for g in grads:
            if g is not None:
                total = g.to(dev) if total is None else total + g.to(dev)
        for j in js:
            tree.shards[j].grad = total.to(tree.shards[j].device, copy=True)


def _rewrap(outs: list, lead: ShardedTensor):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return ShardedTensor(outs, lead.index, lead.mesh)
    if isinstance(first, tuple) and first and isinstance(first[0], torch.Tensor):
        return type(first)(_rewrap(list(col), lead) for col in zip(*outs))
    return first


def _binop(name):
    def op(self, *other):
        return ShardedTensor.map(lambda s, *o: getattr(s, name)(*o), self, *other)
    op.__name__ = name
    return op


for _name in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
              "floordiv", "rfloordiv", "mod", "pow", "matmul", "rmatmul", "and",
              "rand", "or", "ror", "xor", "lt", "le", "gt", "ge", "eq", "ne",
              "neg", "invert", "abs"):
    setattr(ShardedTensor, f"__{_name}__", _binop(f"__{_name}__"))


def split(t: torch.Tensor, dim: int, mesh: Mesh, axis: str = SERVE_TP_AXIS) -> ShardedTensor:
    """``t`` sharded along ``dim`` over ``axis``, replicated on the others."""
    spec = [None] * t.dim()
    spec[dim] = axis
    return ShardedTensor.place(t, mesh, P(*spec))


def axis_shards(st: ShardedTensor, axis: str = SERVE_TP_AXIS) -> list[torch.Tensor]:
    """The shard at each coordinate of ``axis`` (the other coordinates 0)."""
    n = st.mesh.shape[axis]
    ps = [next(p for p in range(st.mesh.size)
               if st.mesh.coords(p)[axis] == i
               and all(v == 0 for a, v in st.mesh.coords(p).items() if a != axis))
          for i in range(n)]
    return [st.shards[st.index[p]] for p in ps]


def _shard_list(x) -> list[torch.Tensor]:
    return list(x.shards) if isinstance(x, ShardedTensor) else list(x)


def all_gather(shards, dim: int) -> torch.Tensor:
    """Concatenate per-shard tensors along ``dim`` on shard 0's device."""
    parts = _shard_list(shards)
    dev = parts[0].device
    return torch.cat([s.to(dev) for s in parts], dim=dim)


def all_reduce_sum(shards) -> torch.Tensor:
    """Sum per-shard tensors on shard 0's device, shard 0 first."""
    parts = _shard_list(shards)
    out = parts[0]
    for s in parts[1:]:
        out = out + s.to(out.device)
    return out


def place_pytree(tree, mesh: Mesh | None, specs=None, *, share: bool = True):
    """Each tensor leaf of a nested dict placed by its entry in ``specs`` (a
    matching nest of :class:`PartitionSpec` / None; replicated where
    missing; ``share`` as :meth:`ShardedTensor.place`). ``mesh=None``
    returns the tree untouched; a one-position mesh moves the leaves to its
    device as plain tensors."""
    if mesh is None:
        return tree

    def walk(node, sp):
        if isinstance(node, dict):
            return {k: walk(v, sp.get(k) if isinstance(sp, dict) else None)
                    for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        if mesh_is_trivial(mesh):
            return node.to(mesh.devices[0])
        return ShardedTensor.place(node, mesh, P() if sp is None else sp, share=share)

    return walk(tree, specs)


def gather_pytree(tree):
    """Every :class:`ShardedTensor` leaf of a nested dict gathered."""
    if isinstance(tree, dict):
        return {k: gather_pytree(v) for k, v in tree.items()}
    return tree.gather() if isinstance(tree, ShardedTensor) else tree


def tree_position_bytes(tree, mesh: Mesh | None = None) -> dict[str, int]:
    """Bytes per mesh position of a nested dict's tensors: a sharded leaf
    charges each position its shard; a plain leaf charges every position
    of ``mesh`` in full (replicated), or ``"0"`` without a mesh."""
    out: dict[str, int] = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, ShardedTensor):
            for key, n in node.position_bytes().items():
                add(key, n)
        elif isinstance(node, torch.Tensor):
            n = node.numel() * node.element_size()
            for p in range(1 if mesh is None else mesh.size):
                add(str(p), n)

    walk(tree)
    return out


def tree_mesh(tree) -> Mesh | None:
    """The mesh of the first sharded leaf of a nested dict, or None."""
    if isinstance(tree, dict):
        for v in tree.values():
            m = tree_mesh(v)
            if m is not None:
                return m
        return None
    return tree.mesh if isinstance(tree, ShardedTensor) else None
