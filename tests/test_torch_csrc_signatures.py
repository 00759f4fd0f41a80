"""Every C entry point of the CUDA sources against the ctypes signature tables
of the wrappers that call it.

A kernel library is loaded with ctypes, which passes each argument as the
table says: a wrong kind or count corrupts the call silently on the card. So
each ``extern "C"`` declaration in ``ops/cuda/csrc/*.cu`` is parsed here and
its parameter kinds (pointer, int, float), in order, are held to its entry in
the ``_SIGS`` table of ``ops/cuda/attention.py``, ``matmul_quant.py``,
``moe_matmul.py`` and ``ssd_step.py``; every entry must have a declaration
and every declaration an entry. Runs on the CPU: nothing is compiled.
"""

import ctypes
import re
from pathlib import Path

import pytest

from mistral_inference_tpu_torch.ops.cuda import attention, matmul_quant, moe_matmul, ssd_step

CSRC = Path(attention.__file__).resolve().parent / "csrc"
TABLES = {
    "attention": attention._SIGS,
    "matmul_quant": matmul_quant._SIGS,
    "moe_matmul": moe_matmul._SIGS,
    "ssd_step": ssd_step._SIGS,
}
KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _kind(param: str) -> str:
    """The ctypes kind of one C parameter declaration."""
    param = " ".join(param.split())
    if "*" in param:
        return "pointer"
    words = param.replace("const ", "").split()
    if words[0] == "int":
        return "int"
    if words[0] == "float":
        return "float"
    raise ValueError(f"parameter of unknown kind: {param!r}")


def _declarations():
    """{(library, function): [kinds]} of every extern "C" declaration."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in DECL.findall(src.read_text()):
            params = params.strip()
            kinds = [] if params in ("", "void") else [_kind(p) for p in params.split(",")]
            assert (src.stem, name) not in found, f"{name} declared twice in {src.name}"
            found[(src.stem, name)] = kinds
    return found


def _entries():
    """{(library, function): [kinds]} of every signature table entry."""
    entries = {}
    for module, table in TABLES.items():
        for key, types in table.items():
            assert key not in entries, f"{key} in two tables"
            entries[key] = [KINDS[t] for t in types]
    return entries


DECLS = _declarations()
ENTRIES = _entries()


def test_declarations_found():
    # Every source holds at least one entry point, and the parser found the
    # attention kernels' declarations across several lines.
    assert {lib for lib, _ in DECLS} == {p.stem for p in CSRC.glob("*.cu")}
    assert len(DECLS["ring_attention", "ring_attention_stats_int8"]) == 20
    assert len(DECLS["fused_decode", "fused_verify_int8"]) == 21


def test_every_entry_has_a_declaration():
    missing = sorted(set(ENTRIES) - set(DECLS))
    assert not missing, f"signature table entries with no C declaration: {missing}"


def test_every_declaration_has_an_entry():
    missing = sorted(set(DECLS) - set(ENTRIES))
    assert not missing, f"C declarations with no signature table entry: {missing}"


@pytest.mark.parametrize("key", sorted(set(DECLS) & set(ENTRIES)), ids=lambda k: f"{k[0]}.{k[1]}")
def test_signature_matches_declaration(key):
    assert ENTRIES[key] == DECLS[key], (
        f"{key[1]} in csrc/{key[0]}.cu takes {DECLS[key]}, its table says {ENTRIES[key]}"
    )
