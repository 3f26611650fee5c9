"""The port's public surface against godsp_tpu's, by AST only.

For every module present in both packages (same relative path), the
public top-level names, the public members of each class both define,
and the parameter names of each function and method both define must be
in the port, unless the allow-list below names them.  A name that
godsp_tpu gains, or that the port loses, fails its module's case until
it is ported or listed.  Nothing here imports jax or either package.

The allow-list has two parts:
  NOT_TO_PORT  mirrors ROADMAP.md §1 "Not to port, or ported under another
               form": TPU structure, the split-plane transfer workaround,
               the Mosaic and large-plan A/B knobs, kernel test hooks, and
               names the port gives another form (each says which);
  PENDING      names that wait for a later slice, each with its ROADMAP
               queue-1 item.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "godsp_tpu"
PORT = REPO / "godsp_tpu_torch"

# (module, name) -> why.  A name "f(p)" is parameter p of function f; a
# name "C.m" is member m of class C; "C.m(p)" a parameter of a method.
NOT_TO_PORT = {
    # The split-plane transfer workaround (ROADMAP §1, North star).
    ("_dtypes.py", "put"): "split-plane transfer workaround",
    ("utils/__init__.py", "to_host"): "split-plane transfer workaround (utils/host.py)",
    # Mosaic A/B knobs (the rest live in godsp_tpu/ops, which has no
    # counterpart module) and TPU layout options.
    ("fft/__init__.py", "set_natural_fused"): "Mosaic knob",
    ("fft/__init__.py", "set_pallas_enabled"): "became set_kernels_enabled",
    ("fft/pow2.py", "set_pallas_enabled"): "became set_kernels_enabled",
    ("parallel/_pwelch_sharded_impl.py", "sharded_partial_step(packed_half)"): "Mosaic knob",
    # The large plan's TPU A/B knobs and test hooks.
    ("fft/large.py", "set_peel_enabled"): "large-plan TPU A/B knob",
    ("fft/large.py", "set_outer_kernel_enabled"): "large-plan TPU A/B knob",
    ("fft/large.py", "fft_large_split(row_fft)"): "test hook of the TPU kernel",
    ("fft/large.py", "fft_large_split(interpret)"): "test hook of the TPU kernel",
    # Kernels ported under another form.
    ("parallel/__init__.py", "ring_halo_pallas"): "ported as parallel.ring_halo (K10)",
    ("utils/metrics.py", "copy_split_pallas"): "ported as utils.metrics.copy_split (K12)",
    ("utils/metrics.py", "gmm_floor_pallas"): "ported as utils.metrics.gmm_floor (K13)",
    # The JAX x64 policy: the port's working type follows the device.
    ("_dtypes.py", "default_float"): "another form: working_float(device)",
    ("_dtypes.py", "default_complex"): "another form: complex_for(working_float(device))",
    ("_dtypes.py", "np_float"): "another form: np_float_for(device)",
    ("_dtypes.py", "np_complex"): "another form: np_float_for(device) and complex_for",
    ("fft/__init__.py", "pallas_enabled"): "became kernels_enabled",
    ("fft/pow2.py", "pallas_enabled"): "became kernels_enabled",
    # TPU layout and the Pallas kernels' own entry points (ops/ holds the
    # CUDA kernels under their wrappers' names instead).
    ("ops/__init__.py", "LANES"): "TPU lane width",
    ("ops/__init__.py", "default_batch_tile"): "TPU tiling",
    ("ops/__init__.py", "digit_to_natural_bins"): "digit bin order (TPU layout)",
    ("ops/__init__.py", "packed_to_natural_onesided"): "packed half-spectrum (TPU layout)",
    ("ops/__init__.py", "fft_pow2_split"): "ported as ops.fft_pow2 (K1)",
    ("ops/__init__.py", "stft_pallas"): "ported as ops.stft_complex/stft_power/stft_mel (K5)",
    # JAX sharding types: a port mesh is a grid of torch devices.
    ("parallel/mesh.py", "NamedSharding"): "jax.sharding type",
    ("parallel/mesh.py", "P"): "jax.sharding.PartitionSpec",
}

# (module, name) -> the ROADMAP queue-1 item that ports it.
PENDING = {
    ("parallel/__init__.py", "init_distributed"): "queue 1 item 6 (more than one card)",
    ("parallel/mesh.py", "init_distributed"): "queue 1 item 6 (more than one card)",
}

# A name a package __init__ re-exports from one of these godsp_tpu modules
# is pending with that module's ROADMAP queue-1 item.
PENDING_MODULES: dict[str, str] = {}


def _module_pairs() -> list[str]:
    ref = {p.relative_to(REF).as_posix() for p in REF.rglob("*.py")}
    port = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    return sorted(ref & port)


def _literal_names(node: ast.AST) -> list[str]:
    """The strings of an __all__ value: a list or tuple literal, or sums
    of them."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_names(node.left) + _literal_names(node.right)
    if isinstance(node, (ast.List, ast.Tuple)):
        return [e.value for e in node.elts if isinstance(e, ast.Constant)]
    return []


def _top_level(body: list[ast.stmt]):
    """Yield the statements bound at module level, through if/try blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body)
            for h in node.handlers:
                yield from _top_level(h.body)
            yield from _top_level(node.orelse)
            yield from _top_level(node.finalbody)
        else:
            yield node


def _bound(node: ast.stmt) -> list[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    names = []
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                names.append(sub.id)
    return names


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


class Surface:
    """What one module binds: top-level names, its public ones, functions'
    parameters, and each class's members and methods' parameters.

    A package __init__ re-exports what it imports from its own package:
    those names are public, and `origin` maps each to its source module."""

    def __init__(self, root: pathlib.Path, module: str):
        tree = ast.parse((root / module).read_text())
        parts = module[: -len(".py")].split("/")
        package = parts[:-1] if parts[-1] == "__init__" else None
        self.bound: set[str] = set()
        self.public: set[str] = set()
        self.origin: dict[str, str] = {}
        self.functions: dict[str, list[str]] = {}
        self.classes: dict[str, dict[str, list[str] | None]] = {}
        for node in _top_level(tree.body):
            self.bound.update(_bound(node))
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
            ):
                self.public.update(_literal_names(node.value))
            elif isinstance(node, ast.ImportFrom) and package is not None:
                src = self._own_module(node, package, root.name)
                for a in node.names if src is not None else ():
                    name = a.asname or a.name
                    self.origin[name] = src
                    if not name.startswith("_"):
                        self.public.add(name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = _params(node)
                if not node.name.startswith("_"):
                    self.public.add(node.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = self._members(node)
                if not node.name.startswith("_"):
                    self.public.add(node.name)

    @staticmethod
    def _own_module(node: ast.ImportFrom, package: list[str], top: str) -> str | None:
        """The path (relative to the package root) of the module a package
        __init__ imports from, when it lies inside that package."""
        if node.level:
            base = package[: len(package) - node.level + 1]
            dotted = base + (node.module.split(".") if node.module else [])
        elif node.module and node.module.split(".")[0] == top:
            dotted = node.module.split(".")[1:]
        else:
            return None
        if dotted[: len(package)] != package:
            return None
        return "/".join(dotted) + ".py" if dotted else "__init__.py"

    @staticmethod
    def _members(cls: ast.ClassDef) -> dict[str, list[str] | None]:
        """member -> its parameters (None for an attribute or a field)."""
        out: dict[str, list[str] | None] = {}
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[node.name] = _params(node)
            else:
                for name in _bound(node):
                    out.setdefault(name, None)
        return out


def _allowed(module: str, name: str, ref: Surface) -> bool:
    if (module, name) in NOT_TO_PORT or (module, name) in PENDING:
        return True
    src = ref.origin.get(name)
    return src is not None and (src in PENDING_MODULES or f"{src[:-3]}/__init__.py"
                                in PENDING_MODULES)


def raw_gaps(module: str, port_root: pathlib.Path = PORT) -> tuple[list[str], Surface]:
    """Every public name, member or parameter of godsp_tpu's `module` that
    the port's module lacks, and godsp_tpu's surface of it."""
    ref, port = Surface(REF, module), Surface(port_root, module)
    found = [name for name in sorted(ref.public) if name not in port.bound]
    for name, params in sorted(ref.functions.items()):
        if name.startswith("_") or name not in port.functions:
            continue
        found += [f"{name}({p})" for p in params if p not in port.functions[name]]
    for cname, members in sorted(ref.classes.items()):
        if cname.startswith("_") or cname not in port.classes:
            continue
        theirs = port.classes[cname]
        for m, params in sorted(members.items()):
            if m.startswith("_") and m != "__init__":
                continue
            if m not in theirs:
                found.append(f"{cname}.{m}")
            elif params is not None and theirs[m] is not None:
                found += [f"{cname}.{m}({p})" for p in params if p not in theirs[m]]
    return found, ref


def gaps(module: str, port_root: pathlib.Path = PORT) -> list[str]:
    """raw_gaps that the allow-list does not name."""
    found, ref = raw_gaps(module, port_root)
    return [g for g in found if not _allowed(module, g, ref)]


MODULES = _module_pairs()


def test_shared_modules_include_the_measurement_path():
    for module in ("utils/__init__.py", "utils/metrics.py", "utils/profiling.py"):
        assert module in MODULES


def test_allow_list_names_only_real_gaps():
    """Every allow-listed entry names a module present in both packages
    and a gap the port really has there (a ported name leaves the list);
    every pending module is one the port lacks."""
    for (module, name), why in {**NOT_TO_PORT, **PENDING}.items():
        assert module in MODULES, module
        assert why, (module, name)
        assert name in raw_gaps(module)[0], (module, name)
    for module in PENDING_MODULES:
        assert (REF / module).is_file() and not (PORT / module).exists(), module


@pytest.mark.parametrize("module", MODULES)
def test_public_surface(module):
    missing = gaps(module)
    assert missing == [], f"godsp_tpu_torch/{module} lacks {missing}"


@pytest.mark.parametrize("module, old, new, name", [
    ("window/__init__.py", "def apply(", "def _gone(", "apply"),
    ("wav/__init__.py", "def read_channels(", "def _gone(", "Wav.read_channels"),
    ("native/__init__.py", "def frame_signal(", "def _gone(", "frame_signal"),
    ("native/__init__.py", "def dtype(", "def _gone(", "StreamBuffer.dtype"),
    ("__init__.py", "import windows", "import windows as _gone", "windows"),
    ("models/__init__.py", "import detrend", "import detrend as _gone", "detrend"),
])
def test_a_deleted_name_is_found(tmp_path, module, old, new, name):
    """The comparison finds a name removed from a shared module: each of
    the gaps it was written to catch."""
    src = (PORT / module).read_text()
    assert old in src
    fake = tmp_path / module
    fake.parent.mkdir(parents=True, exist_ok=True)
    fake.write_text(src.replace(old, new))
    assert name in gaps(module, tmp_path)
