"""The kernel build on a host without nvcc: what is compiled, what is
hashed into the library's name, and the sources' shared helpers, checked
with a stand-in compiler on a temporary source tree."""

import re
from pathlib import Path

import pytest

from memvul_tpu_torch.ops import _kernels

CSRC = Path(_kernels.__file__).resolve().parents[1] / "csrc"


class _FakeCompiler:
    """Stands in for nvcc: records each command and writes its output."""

    def __init__(self):
        self.commands = []

    def _run(self, argv):
        self.commands.append([str(a) for a in argv])
        out = Path(argv[argv.index("-o") + 1])
        out.write_bytes(b"")

    def popen(self, argv, **kwargs):
        self._run(argv)
        compiler = self

        class _Proc:
            returncode = 0

            def communicate(self):
                return f"ptxas info    : stand-in for {compiler.commands[-1][-3]}", None

        return _Proc()

    def run(self, argv, **kwargs):
        self._run(argv)

        class _Done:
            returncode = 0
            stdout = ""

        return _Done()


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A source tree of two translation units and one header, built into
    a temporary directory by the stand-in compiler."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "common.cuh").write_text("#pragma once\nconstexpr int kA = 1;\n")
    (src / "a.cu").write_text('#include "common.cuh"\nint a() { return kA; }\n')
    (src / "b.cu").write_text('#include "common.cuh"\nint b() { return kA + 1; }\n')
    fake = _FakeCompiler()
    monkeypatch.setattr(_kernels, "CSRC", src)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", fake.popen)
    monkeypatch.setattr(_kernels.subprocess, "run", fake.run)
    return src, fake


def test_header_edit_changes_the_library_name(tree):
    src, fake = tree
    first = _kernels.build()
    assert first.exists()
    assert _kernels.build() == first  # an unchanged tree reuses the build
    calls = len(fake.commands)
    (src / "common.cuh").write_text("#pragma once\nconstexpr int kA = 2;\n")
    second = _kernels.build()
    assert second != first and second.exists()
    assert len(fake.commands) > calls  # rebuilt, not reused
    (src / "a.cu").write_text('#include "common.cuh"\nint a() { return 2 * kA; }\n')
    assert _kernels.build() not in (first, second)


def test_only_translation_units_are_compiled(tree):
    src, fake = tree
    _kernels.build()
    compiled = [cmd[cmd.index("-c") + 1] for cmd in fake.commands if "-c" in cmd]
    assert sorted(Path(c).name for c in compiled) == ["a.cu", "b.cu"]
    assert not any(arg.endswith(".cuh") for cmd in fake.commands for arg in cmd)
    assert [p.name for p in _kernels.sources()] == ["a.cu", "b.cu"]
    assert [p.name for p in _kernels.headers()] == ["common.cuh"]
    # one link of the two objects into the library
    links = [cmd for cmd in fake.commands if "-shared" in cmd]
    assert len(links) == 1 and sum(arg.endswith(".o") for arg in links[0]) == 2


def test_flags_are_part_of_the_name(tree, monkeypatch):
    first = _kernels.build()
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ["-lineinfo"])
    assert _kernels.build() != first


def _defined_in(helper):
    """The csrc files that define ``helper`` (a function of one of the
    helpers' return types)."""
    definition = re.compile(
        rf"\b(?:void|float|uint32_t|uint64_t|bool|T|__nv_bfloat16|EncodeTiledFn)\s+{helper}(?:<[^>]*>)?\s*\(")
    return sorted(p.name for p in sorted(CSRC.iterdir())
                  if p.suffix in (".cu", ".cuh") and definition.search(p.read_text()))


@pytest.mark.parametrize(
    "helper",
    ["to_f32", "from_f32", "round_to", "pack_bf16", "smem_u32", "exp2_approx",
     "tensor_core_eligible"],
)
def test_each_device_helper_is_defined_once(helper):
    """The shared helpers live in common.cuh alone; the sources include it."""
    assert _defined_in(helper) == ["common.cuh"]


@pytest.mark.parametrize(
    "helper",
    ["mbar_init", "mbar_fence_init", "mbar_arrive", "mbar_arrive_expect_tx", "mbar_expect_tx",
     "mbar_wait", "tma_prefetch_map", "tma_load_4d", "tma_load_2d", "setmaxnreg_dec", "setmaxnreg_inc",
     "wgmma_desc_sw128", "wgmma_desc_advance", "wgmma_fence", "wgmma_commit", "wgmma_wait",
     "fence_regs", "wgmma_m64n128k16_ss", "wgmma_m64n64k16_ss", "wgmma_m64n64k16_rs",
     "encode_tiled_fn", "encode_bf16_rows", "encode_i32_run"],
)
def test_each_hopper_helper_is_defined_once(helper):
    """The Hopper pieces (mbarriers, TMA, wgmma) live in hopper.cuh alone."""
    assert _defined_in(helper) == ["hopper.cuh"]


def test_sources_share_the_headers_and_the_old_kernel_is_gone():
    assert [p.name for p in _kernels.headers()] == ["common.cuh", "hopper.cuh"]
    for src in _kernels.sources():
        assert '#include "common.cuh"' in src.read_text(), src.name
    flash = (CSRC / "flash_fwd.cu").read_text()
    assert '#include "hopper.cuh"' in flash
    assert "flash_fwd_wgmma_kernel" in flash
    assert "flash_fwd_mma_kernel" not in flash
    ragged = (CSRC / "ragged_fwd.cu").read_text()
    assert '#include "hopper.cuh"' in ragged
    assert "ragged_fwd_wgmma_kernel" in ragged
    assert "ragged_fwd_mma_kernel" not in ragged
    # no mma.sync product is left in any source: the bf16 paths run wgmma
    assert not any("mma.sync" in p.read_text() for p in CSRC.iterdir())
    for name in ("kF32Min =", "kLog2e =", "struct Strides"):
        assert [p.name for p in sorted(CSRC.iterdir()) if name in p.read_text()] == ["common.cuh"]


def test_prototypes_match_the_exported_entry_points():
    exported = set()
    for src in _kernels.sources():
        exported |= set(re.findall(r'extern "C" [\w\s\*]+?\b(memvul_\w+)\s*\(', src.read_text()))
    assert exported == set(_kernels.PROTOTYPES) | {"memvul_error_string"}
