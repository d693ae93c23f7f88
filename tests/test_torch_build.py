"""The key under which the port's CUDA libraries are built and reused.

``_build.library_path`` hashes a library's sources, every ``*.cuh``
header under ``csrc/`` and the compiler flags: editing a header the
sources include must build the library anew rather than load a stale
one. No compiler is needed: only the key is computed.
"""

import pytest

from paddle_tpu_torch.ops.hopper import _build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (d / "b.cu").write_text("int b;\n")
    (d / "h.cuh").write_text("#pragma once\n")
    return d


def _key(csrc, name="lib", sources=("a.cu",)):
    return _build.library_path(name, list(sources), csrc,
                               csrc.parent / "build")


@pytest.mark.parametrize("edit", ["source", "header", "new_header"])
def test_library_key_follows_sources_and_headers(csrc, edit):
    """Changing the source, a header or adding a header changes the key;
    a file the library does not build from leaves it alone."""
    before = _key(csrc)
    (csrc / "b.cu").write_text("int b2;\n")
    assert _key(csrc) == before
    target = {"source": "a.cu", "header": "h.cuh",
              "new_header": "g.cuh"}[edit]
    (csrc / target).write_text("// changed\n")
    assert _key(csrc) != before


def test_library_key_names_the_library(csrc):
    """The key is ``build/lib<name>-<16 hex digits>.so`` in the checkout's
    build directory, and differs between libraries."""
    path = _key(csrc, "flash")
    assert path.parent == csrc.parent / "build"
    assert path.name.startswith("libflash-") and path.suffix == ".so"
    assert len(path.stem.split("-")[1]) == 16
    assert _key(csrc, "other", ("b.cu",)) != _key(csrc, "flash")
