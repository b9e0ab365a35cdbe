"""The kernel measurement tools' source handling (``tools/kernel_ab.py``,
``tools/kernel_variants.py``), which runs only on a card: the texts the
ablations replace are in the shared scan, a timed earlier library is
swapped in for one call only, and the SASS comparison's kernel names drop
the anonymous namespace's path-dependent tag."""

import importlib.util
from pathlib import Path

import pytest

_TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, _TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def variants():
    return _load("kernel_variants")


def test_ablation_texts_are_in_the_scan(variants):
    header = (variants.CSRC / "hopper_scan.cuh").read_text()
    for name, subs in variants.VARIANTS.items():
        for old, _ in subs:
            assert header.count(old) == 1, name


@pytest.mark.parametrize("fails", [False, True])
def test_through_puts_the_library_back(fails):
    """``kernel_ab.through``: the call runs on the swapped library, and the
    one the source had is back after it, also where the call raises."""
    ab = _load("kernel_ab")

    class Source:
        _lib = "today"

    seen = []

    def call():
        seen.append(Source._lib)
        if fails:
            raise RuntimeError("launch failed")
        return 7

    run = ab.through(Source, "earlier", call)
    if fails:
        with pytest.raises(RuntimeError):
            run()
    else:
        assert run() == 7
    assert seen == ["earlier"] and Source._lib == "today"


@pytest.mark.parametrize("name,want", [
    ("_ZN3fpv11scan_kernelIN45_GLOBAL__N__4a238a26_12_s8_scores_cu_"
     "27a93ffb4S8OpILb0EEEEEv14CUtensorMap_stS4_S4_NT_6ParamsEiiiii",
     "_ZN3fpv11scan_kernelIN45_GLOBAL__N_4S8OpILb0EEEEEv14CUtensorMap_stS4_"
     "S4_NT_6ParamsEiiiii"),
    ("_ZN3fpv11scan_kernelIN48_GLOBAL__N__8238d5cc_15_quant_scores_cu_"
     "117be63d7QuantOpILi1EEEEEv14CUtensorMap_stS4_S4_NT_6ParamsEiiiii",
     "_ZN3fpv11scan_kernelIN48_GLOBAL__N_7QuantOpILi1EEEEEv14CUtensorMap_"
     "stS4_S4_NT_6ParamsEiiiii"),
    ("_ZN3fpv17topc_merge_kernelILi4EEEvPK5uint2PfPxiiiii",
     "_ZN3fpv17topc_merge_kernelILi4EEEvPK5uint2PfPxiiiii"),
])
def test_sass_names_drop_the_namespace_tag(name, want):
    assert _load("kernel_ab").unhash(name) == want
