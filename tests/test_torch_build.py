"""The port's kernel build on the CPU: what the library digest covers.

``_build.library_path`` names each built library by a digest of its
source; a shared header (``csrc/attn_mma.cuh``, included by both attention
kernels) must be part of that digest, or an edit to the header alone would
load a stale library on the card. No nvcc is needed: only paths are
computed here.
"""
import re
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_header_edit_changes_both_attention_libraries(csrc_copy):
    names = ("flash_attention", "paged_flash_attention")
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}   # stable
    header = csrc_copy / "attn_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    for n in names:
        assert after[n] != before[n], n
        assert after[n].name.startswith(f"lib{n}-")


def test_includes_name_files_in_csrc():
    """Every ``#include "..."`` of a source is a file beside it, so the
    headers the digest hashes are the ones nvcc reads."""
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "attn_mma.cuh" in headers
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert (_build.CSRC / inc).is_file(), f"{name}.cu: {inc}"
