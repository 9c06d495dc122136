"""Type-stub consistency of vali_tpu_torch: tests/test_stub.py's three
checks on the port's __init__.pyi, and the port's stub held to
vali_tpu's: the same classes, functions, aliases, members and parameter
names, up to the port's deliberate differences, each named below."""

import ast
import os
import re
import types

import pytest

import vali_tpu
import vali_tpu_torch as vali

STUB = os.path.join(os.path.dirname(os.path.abspath(vali.__file__)),
                    "__init__.pyi")
REF_STUB = os.path.join(os.path.dirname(os.path.abspath(vali_tpu.__file__)),
                        "__init__.pyi")

#: 1. the port's kernels are CUDA, not Pallas: use_pallas -> use_kernel;
#: 2. (with RENAMED_MEMBERS) torch tensor views in place of JAX arrays:
#: Surface.from_torch takes tensors where from_jax takes arrays
RENAMED_PARAMETERS = {"use_pallas": "use_kernel", "arrays": "tensors"}
#: 2. torch tensor views (and DLPack, which both stubs declare) in place
#: of JAX arrays
RENAMED_MEMBERS = {"to_jax": "to_torch", "from_jax": "from_torch",
                   "plane_arrays": "plane_tensors"}
#: 3. and 4. keyword-only parameters of the port's own: the device a
#: decoder's Surface path writes to, and the card (or -1, the CPU) of a
#: Surface made from a CUDA array interface
PORT_KEYWORDS = {("PyDecoder", "__init__"): {"device"},
                 ("Surface", "from_cai"): {"gpu_id"}}
#: 5. the port exports MultiStreamPipeline at its top level, so its stub
#: declares it (vali_tpu keeps it in vali_tpu.pipeline.multistream)
PORT_CLASSES = {"MultiStreamPipeline"}


def stub_symbols(path=STUB):
    tree = ast.parse(open(path).read())
    classes, functions, aliases = set(), set(), set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            classes.add(node.name)
        elif isinstance(node, ast.FunctionDef):
            functions.add(node.name)
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            aliases.add(node.target.id)
    return classes, functions, aliases


def test_stub_covers_public_api():
    classes, functions, aliases = stub_symbols()
    public = [n for n in dir(vali) if not n.startswith("_")
              and not isinstance(getattr(vali, n), types.ModuleType)]
    missing = []
    for name in public:
        obj = getattr(vali, name)
        if isinstance(obj, type):
            if name not in classes:
                missing.append(name)
        elif callable(obj):
            if name not in functions and name not in classes:
                missing.append(name)
        else:
            if name not in aliases and name not in classes:
                missing.append(name)
    assert not missing, f"stub missing public symbols: {missing}"


def test_stub_symbols_exist_at_runtime():
    classes, functions, aliases = stub_symbols()
    stale = [n for n in (classes | functions | aliases)
             if not hasattr(vali, n)]
    assert not stale, f"stub declares nonexistent symbols: {stale}"


def test_stub_enum_members_match():
    """Every enum member listed in the stub matches the runtime enum."""
    text = open(STUB).read()
    for enum_name in ("PixelFormat", "ColorSpace", "ColorRange",
                      "TaskExecInfo", "DecodeMode", "FfmpegLogLevel",
                      "NV_ENC_CAPS"):
        enum_cls = getattr(vali, enum_name)
        m = re.search(
            rf"class {enum_name}\(enum.IntEnum\):\n((?:    \w+: int\n)+)",
            text)
        assert m, f"stub lacks members for {enum_name}"
        stub_members = set(re.findall(r"(\w+): int", m.group(1)))
        runtime = {e.name for e in enum_cls}
        assert stub_members == runtime, (enum_name, stub_members ^ runtime)


def test_top_level_names_agree_with_vali_tpus_stub():
    ours, ref = stub_symbols(STUB), stub_symbols(REF_STUB)
    assert ours[0] - PORT_CLASSES == ref[0]
    assert PORT_CLASSES <= ours[0]
    assert ours[1:] == ref[1:]


def _classes(path):
    return {n.name: n for n in ast.parse(open(path).read()).body
            if isinstance(n, ast.ClassDef)}


def _members(cls):
    """{member: (positional names, keyword-only names) or None for a
    field}; a method declared twice (overloads) keeps its first
    declaration's parameters and the names of all."""
    out = {}
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            a = node.args
            pos = [p.arg for p in a.posonlyargs + a.args]
            kw = {p.arg for p in a.kwonlyargs}
            if node.name in out:
                pos = sorted(set(pos) | set(out[node.name][0]))
            out[node.name] = (pos, kw)
        elif isinstance(node, ast.AnnAssign):
            out[node.target.id] = None
    return out


_REF_CLASSES = _classes(REF_STUB)


@pytest.mark.parametrize("name", sorted(_REF_CLASSES))
def test_class_members_agree_with_vali_tpus_stub(name):
    ref = _members(_REF_CLASSES[name])
    ours = _members(_classes(STUB)[name])
    assert set(ours) == {RENAMED_MEMBERS.get(m, m) for m in ref}
    for member, params in ref.items():
        mine = ours[RENAMED_MEMBERS.get(member, member)]
        if params is None:
            assert mine is None, member
            continue
        pos, kw = params
        assert mine[0] == [RENAMED_PARAMETERS.get(p, p) for p in pos], \
            member
        assert mine[1] == {RENAMED_PARAMETERS.get(p, p) for p in kw} | \
            PORT_KEYWORDS.get((name, member), set()), member


def _code(path):
    """The stub's declarations, its docstring left out."""
    tree = ast.parse(open(path).read())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.unparse(tree)


def test_every_listed_difference_occurs():
    """The lists above hold no difference the stubs do not have."""
    ref, ours = _code(REF_STUB), _code(STUB)
    for a, b in list(RENAMED_PARAMETERS.items()) + list(
            RENAMED_MEMBERS.items()):
        assert a in ref and a not in ours and b in ours and b not in ref
    for (cls, member), kws in PORT_KEYWORDS.items():
        (fn,) = [n for n in _classes(STUB)[cls].body
                 if isinstance(n, ast.FunctionDef) and n.name == member]
        assert {p.arg for p in fn.args.kwonlyargs} == kws
    assert not PORT_CLASSES & set(_REF_CLASSES)


def test_stub_names_torch_types_and_no_jax_type():
    tree = ast.parse(open(STUB).read())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    attrs = {ast.unparse(n) for n in ast.walk(tree)
             if isinstance(n, ast.Attribute)}
    assert not any("jax" in n.lower() for n in names | attrs)
    assert {"torch.Tensor", "torch.device", "torch.dtype"} <= attrs
    imports = {a.name for n in tree.body if isinstance(n, ast.Import)
               for a in n.names}
    assert "torch" in imports and not any("jax" in i for i in imports)


def test_port_package_is_typed():
    assert os.path.isfile(os.path.join(os.path.dirname(STUB), "py.typed"))
