"""The plan data that the reshard check reads: the port's own copy of
what it needs from the JAX package's ``analysis/plan`` (``spec.py``'s
``MeshSpec``, ``PlanSpec`` and ``normalize_pspec``; ``contracts.py``'s
``check_divisibility`` and ``reshard_compat``), pure data and the same
verdicts.  The rest of that analysis layer is not ported."""
from __future__ import annotations

__all__ = ["MeshSpec", "PlanSpec", "normalize_pspec", "check_divisibility",
           "reshard_compat"]


class MeshSpec:
    """Ordered named mesh axes, as pure data."""

    __slots__ = ("axes",)

    def __init__(self, axes):
        if hasattr(axes, "items"):
            axes = list(axes.items())
        self.axes = [(str(a), int(s)) for a, s in axes]

    @property
    def size(self):
        n = 1
        for _a, s in self.axes:
            n *= s
        return n

    def axis_size(self, name):
        for a, s in self.axes:
            if a == name:
                return s
        raise KeyError("mesh has no axis %r (axes: %s)"
                       % (name, [a for a, _s in self.axes]))

    def factor(self, entry):
        """How many ways one PartitionSpec entry splits a dim."""
        if entry is None:
            return 1
        axes = entry if isinstance(entry, (list, tuple)) else (entry,)
        f = 1
        for a in axes:
            f *= self.axis_size(a)
        return f


def normalize_pspec(spec, ndim):
    """A PartitionSpec (or a plain list) as ``ndim`` entries of ``None``
    or ``[axis, ...]``."""
    entries = list(spec) if spec is not None else []
    out = []
    for i in range(ndim):
        e = entries[i] if i < len(entries) else None
        if e is None:
            out.append(None)
        elif isinstance(e, (list, tuple)):
            out.append([str(a) for a in e])
        else:
            out.append([str(e)])
    return out


class PlanSpec:
    """One trainer's plan, declaratively: the fields the reshard check
    reads."""

    def __init__(self, name, kind, origin, mesh=None, params=(), zero=0,
                 optimizer=None, buckets=(), codec=None, batch=None):
        self.name = str(name)
        self.kind = str(kind)
        self.origin = str(origin)
        self.mesh = mesh
        self.params = [dict(p) for p in params]
        self.zero = int(zero)
        self.optimizer = dict(optimizer or {"slots": [],
                                            "scalar_slots": []})
        self.buckets = [dict(b) for b in buckets]
        self.codec = dict(codec) if codec else None
        self.batch = dict(batch) if batch else None

    @classmethod
    def from_trainer(cls, trainer, name="trainer"):
        """A live ``ParallelTrainer``'s plan (``trainer.plan_spec()``)."""
        d = trainer.plan_spec()
        return cls(name=name, kind="trainer",
                   origin="mxnet_tpu_torch/parallel/trainer.py",
                   mesh=MeshSpec(d["mesh"]), params=d["params"],
                   zero=d["zero"], optimizer=d["optimizer"],
                   buckets=d["buckets"], codec=d["codec"],
                   batch=d.get("batch"))


def check_divisibility(spec):
    """Every sharded dim must divide the product of its mesh axes, every
    bucket's padded length the mesh size, and the batch its sharding
    axes."""
    mesh = spec.mesh
    problems = []
    if mesh is None:
        return problems
    for p in spec.params:
        shape = tuple(p["shape"])
        for dim, entry in enumerate(p.get("spec") or ()):
            if entry is None:
                continue
            f = mesh.factor(entry)
            if f > 1 and (dim >= len(shape) or shape[dim] % f):
                problems.append({
                    "contract": "divisibility", "param": p["name"],
                    "detail": "dim %d of %s (shape %s) does not divide "
                              "mesh axes %s (=%d)"
                              % (dim, p["name"], shape,
                                 "x".join(entry), f)})
    n = mesh.size
    for b in spec.buckets:
        if int(b["padded_n"]) % n:
            problems.append({
                "contract": "divisibility", "param": "bucket %d"
                % b["index"],
                "detail": "bucket %d padded length %d does not divide "
                          "the %d-way mesh" % (b["index"],
                                               b["padded_n"], n)})
    if spec.batch:
        bshape = tuple(spec.batch.get("shape") or ())
        f = 1
        for a in spec.batch.get("axes", ()):
            f *= mesh.axis_size(a)
        if bshape and f > 1 and bshape[0] % f:
            problems.append({
                "contract": "divisibility", "param": "batch",
                "detail": "batch dim %d does not divide its sharding "
                          "axes %s (=%d)"
                          % (bshape[0],
                             "x".join(spec.batch.get("axes", ())), f)})
    return problems


def _slot_names(spec):
    return sorted(spec.optimizer.get("slots", ()))


def reshard_compat(saved, target):
    """Reshard-on-restore verdict between two plans: parameter names and
    shapes and the optimizer's slot vocabulary must match; mesh width,
    ZeRO stage and bucket plan may differ (notes); saved residuals into
    an uncompressed target are dropped (a note)."""
    problems, notes = [], []
    saved_p = {p["name"]: tuple(p["shape"]) for p in saved.params}
    target_p = {p["name"]: tuple(p["shape"]) for p in target.params}
    for name, shape in sorted(target_p.items()):
        if name not in saved_p:
            problems.append({
                "contract": "reshard-restore",
                "detail": "checkpoint is missing param %r" % name})
        elif saved_p[name] != shape:
            problems.append({
                "contract": "reshard-restore",
                "detail": "param %r has shape %s in the checkpoint, "
                          "%s in the target trainer"
                          % (name, saved_p[name], shape)})
    if _slot_names(saved) != _slot_names(target):
        problems.append({
            "contract": "reshard-restore",
            "detail": "optimizer slots %s do not match the target's %s "
                      "(different optimizer family)"
                      % (_slot_names(saved), _slot_names(target))})
    if saved.codec and not target.codec:
        notes.append("saved error-feedback residuals are dropped: the "
                     "target runs uncompressed")
    if saved.mesh and target.mesh and \
            saved.mesh.size != target.mesh.size:
        notes.append("mesh width %d -> %d: params and slots reshard on "
                     "restore" % (saved.mesh.size, target.mesh.size))
    if saved.zero != target.zero:
        notes.append("zero stage %d -> %d: slots re-flatten into the "
                     "target layout" % (saved.zero, target.zero))
    problems.extend(check_divisibility(target))
    return {"compatible": not problems, "problems": problems,
            "notes": notes}
