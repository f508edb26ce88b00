"""The port's public surface against the JAX package's, name by name.

Both source trees are read with `ast`: nothing is imported or compiled.
For every module of `ocaml_hnsw_tpu/` (except `ops/pallas/`, `oracle/` and
`native/`, which the port shares as they are, and `utils/cache.py`, on the
"Not ported" list), the port module at the same relative path must exist
and:

- define every public top-level def, class and assignment of the JAX
  module, and every public name the JAX module imports from its own package
  and uses (an `__init__` re-exports all of its imports), with an equal
  `__all__`;
- accept every parameter name of each public JAX function and method, and
  require no parameter that the JAX one does not require, so a JAX call
  shape works;
- give each public JAX class every public method, property and attribute
  (class-level, or assigned to `self` in a method).

What the port leaves out on purpose is on one list, `EXCLUDED`, each entry
with its reason; an entry that no longer names a real gap fails the test.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "ocaml_hnsw_tpu"
PORT_PKG = ROOT / "ocaml_hnsw_tpu_torch"
SHARED = ("ops/pallas/", "oracle/", "native/")
NOT_PORTED = ("utils/cache.py",)

_SHARDED = "parallel/sharded.py"
_MESH_ARGS = {
    "sharded_knn": (("mesh", "stacked", "n_shards", "seed_bank", "seed_n"),
                    ("graphs",)),
    "sharded_pack": (("mesh", "stacked"), ("graphs",)),
    "sharded_knn_packed": (("mesh", "stacked", "pay", "meta", "scale",
                            "n_shards", "seed_bank", "seed_n"),
                           ("graphs", "packs", "banks")),
    "sharded_insert_round": (("mesh", "stacked", "seed_bank", "seed_n",
                              "seed_vecs", "seed_norms"),
                             ("graphs", "banks", "max_levels")),
}
_ROUND_STATE = ("seed_bank", "seed_n", "seed_vecs", "seed_norms", "pack_pay",
                "pack_meta", "pack_scale", "pack_dist")

#: name -> (reason, the gaps it covers).  Gap keys: ("name", module, name);
#: ("param", module, function, parameter) for a JAX parameter the port does
#: not accept; ("required", module, function, parameter) for a port
#: parameter without a default that JAX does not require; ("member",
#: module, class, name) for a class member.
EXCLUDED = {
    "lax.scan round chunks": (
        "the `lax.scan` round chunks are on the Not-ported list: the port "
        "runs rounds in a plain loop",
        {("name", "models/build.py", "insert_rounds_scan"),
         ("member", "models/build.py", "BuildState", "SCAN_CHUNK"),
         ("member", "models/build.py", "BuildState", "SCAN_CHUNKS"),
         ("name", _SHARDED, "sharded_insert_rounds_scan"),
         ("name", _SHARDED, "insert_rounds_scan"),
         ("member", _SHARDED, "ShardedIndex", "SCAN_CHUNKS")}),
    "mesh and stacked shards": (
        "JAX runs the sharded steps under shard_map over a mesh axis on "
        "stacked per-shard arrays; the port's one process drives a list of "
        "torch.devices with lists of per-device graphs, banks and packs",
        {("name", _SHARDED, "AXIS")}
        | {("param", _SHARDED, fn, p)
           for fn, (gone, _) in _MESH_ARGS.items() for p in gone}
        | {("required", _SHARDED, fn, p)
           for fn, (_, new) in _MESH_ARGS.items() for p in new}),
    "REV_BLOCK_ROWS": (
        "the JAX reverse-scatter block size; the port places reverse edges "
        "with one stable sort (`_dup_rank`)",
        {("name", "models/build.py", "REV_BLOCK_ROWS")}),
    "nibble_unpack_bf16": (
        "its counterpart is ops/kernels/payload_score.py::nibble_unpack",
        {("name", "models/packed.py", "nibble_unpack_bf16")}),
    "search.py's bitonic_sort": (
        "an import JAX's search.py uses for its seed top-k; the port's "
        "seed scan selects inside K3 (ops/kernels/scan_topk.py)",
        {("name", "models/search.py", "bitonic_sort")}),
    "SeedIndex.bias": (
        "JAX adds a +inf score bias at dead seed rows; the port's SeedIndex "
        "holds K3's operands, where a bool `dead` masks them",
        {("member", "models/search.py", "SeedIndex", "bias")}),
    "packed.py's merge_into_beam": (
        "an import JAX's packed.py uses in its beam step; the port's beam "
        "step merges in K4 (ops/kernels/beam_update.py, whose plain version "
        "calls ops/sortmerge.py::merge_into_beam)",
        {("name", "models/packed.py", "merge_into_beam")}),
    "HIGHEST and precision=": (
        "the port's f32 products are always exact f32 with TF32 off "
        "(`require_full_f32_matmul`): there is no precision to choose",
        {("name", "ops/distance.py", "HIGHEST"),
         ("name", "models/flat.py", "HIGHEST"),
         ("param", "ops/distance.py", "pairwise_dists", "precision")}),
    "insert_round's round state": (
        "the port's insert_round takes the seed bank as one `bank: "
        "SeedBank`, the payload as `packed`, and the host mirror "
        "`max_level`; BuildState keeps them as `bank` and `packed`",
        {("param", "models/build.py", "insert_round", p)
         for p in _ROUND_STATE}
        | {("required", "models/build.py", "insert_round", "max_level")}
        | {("member", "models/build.py", "BuildState", p)
           for p in _ROUND_STATE}),
}


def _modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        if not rel.startswith(SHARED) and rel not in NOT_PORTED:
            yield rel


MODULES = list(_modules())


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for e in ast.walk(t):
            if isinstance(e, ast.Name):
                yield e.id


class Surface:
    """The public surface of one module's source."""

    def __init__(self, path: Path, package: str):
        tree = ast.parse(path.read_text())
        self.names, self.functions, self.classes = set(), {}, {}
        self.all = None
        used = {e.id for e in ast.walk(tree)
                if isinstance(e, ast.Name) and isinstance(e.ctx, ast.Load)}
        is_init = path.name == "__init__.py"
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.names.add(node.name)
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.names.add(node.name)
                self.classes[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for name in _targets(node):
                    self.names.add(name)
                    if name == "__all__":
                        self.all = ast.literal_eval(node.value)
            elif isinstance(node, ast.ImportFrom) and (
                    node.level or (node.module or "").startswith(package)):
                for alias in node.names:
                    name = alias.asname or alias.name
                    if is_init or name in used:
                        self.names.add(name)
        self.names = {n for n in self.names if _public(n)}


def _members(cls: ast.ClassDef) -> dict:
    """Public methods / properties (name -> def) and attributes (name ->
    None) of a class."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(dict.fromkeys(_targets(node)))
        elif isinstance(node, ast.FunctionDef):
            out[node.name] = node
            for e in ast.walk(node):
                if (isinstance(e, ast.Attribute) and isinstance(e.ctx, ast.Store)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"):
                    out.setdefault(e.attr, None)
    return {k: v for k, v in out.items() if _public(k) or k == "__init__"}


def _params(fn) -> tuple[set, set]:
    """(every parameter name, the names without a default)."""
    a = fn.args
    positional = a.posonlyargs + a.args
    n_req = len(positional) - len(a.defaults)
    names = {p.arg for p in positional + a.kwonlyargs} - {"self", "cls"}
    required = {p.arg for p in positional[:n_req]} | {
        p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is None}
    return names, required - {"self", "cls"}


def _signature_gaps(rel: str, where: str, jfn, pfn) -> set:
    j_names, j_required = _params(jfn)
    p_names, p_required = _params(pfn)
    return ({("param", rel, where, p) for p in j_names - p_names}
            | {("required", rel, where, p) for p in p_required - j_required})


def gaps(rel: str) -> set:
    """Every difference of the port module `rel` from the JAX module."""
    port_path = PORT_PKG / rel
    if not port_path.exists():
        return {("module", rel)}
    j = Surface(JAX_PKG / rel, "ocaml_hnsw_tpu")
    p = Surface(port_path, "ocaml_hnsw_tpu_torch")
    out = {("name", rel, n) for n in j.names - p.names}
    if j.all != p.all:
        out.add(("all", rel))
    for name, jfn in j.functions.items():
        if _public(name) and name in p.functions:
            out |= _signature_gaps(rel, name, jfn, p.functions[name])
    for name, jcls in j.classes.items():
        if not (_public(name) and name in p.classes):
            continue
        j_members, p_members = _members(jcls), _members(p.classes[name])
        for member, jdef in j_members.items():
            if member not in p_members:
                out.add(("member", rel, name, member))
            elif jdef is not None and p_members[member] is not None:
                out |= _signature_gaps(rel, f"{name}.{member}", jdef,
                                       p_members[member])
    return out


def _excluded() -> set:
    return set().union(*(keys for _, keys in EXCLUDED.values()))


def test_every_module_is_compared():
    assert len(MODULES) >= 25
    assert {"api.py", "config.py", "models/build.py", "models/bulk.py",
            "ops/__init__.py", "models/__init__.py"} <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_covers_jax_module(rel):
    missing = sorted(gaps(rel) - _excluded())
    assert not missing, f"the port lacks, against ocaml_hnsw_tpu/{rel}: " \
        f"{missing}"


@pytest.mark.parametrize("entry", sorted(EXCLUDED))
def test_exclusion_entry_is_not_stale(entry):
    reason, keys = EXCLUDED[entry]
    assert reason and keys
    real = set().union(*(gaps(k[1]) for k in keys))
    stale = sorted(keys - real)
    assert not stale, f"{entry!r} names gaps the port no longer has: {stale}"


def test_surface_reader_sees_a_gap(tmp_path):
    """The reader itself: a dropped name, parameter, default, member and
    `__all__` entry each show up as a gap."""
    jax_src = (
        "from ocaml_hnsw_tpu.x import used, unused\n"
        "__all__ = ['f']\n"
        "A = 1\n"
        "def f(a, b=1, *, c=2):\n    return used\n"
        "class C:\n"
        "    K = 3\n"
        "    def __init__(self):\n        self.attr = 1\n"
        "    @property\n    def prop(self):\n        return 1\n")
    port_src = (
        "__all__ = []\n"
        "def f(a, *, c, d):\n    pass\n"
        "class C:\n"
        "    def __init__(self):\n        pass\n")
    (tmp_path / "j.py").write_text(jax_src)
    (tmp_path / "p.py").write_text(port_src)
    j = Surface(tmp_path / "j.py", "ocaml_hnsw_tpu")
    p = Surface(tmp_path / "p.py", "ocaml_hnsw_tpu_torch")
    assert j.names - p.names == {"A", "used"}
    assert j.all != p.all
    assert _signature_gaps("m", "f", j.functions["f"], p.functions["f"]) == {
        ("param", "m", "f", "b"), ("required", "m", "f", "c"),
        ("required", "m", "f", "d")}
    assert set(_members(j.classes["C"])) - set(_members(p.classes["C"])) == {
        "K", "attr", "prop"}
