"""The port's native host runtime on the CPU: its tokenizer and packer
against the port's Python versions (ASCII) and against the reference's
native library (everywhere), a failed build that raises, and builds by
several processes at once that leave one loadable library."""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from svoc_tpu.models.packing import pack_tokens_auto as ref_pack_tokens_auto
from svoc_tpu.runtime import NativeHashingTokenizer as RefNativeTokenizer

from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.packing import fill_ratios, pack_tokens, pack_tokens_auto, strip_padding
from svoc_torch.models.tokenizer import HashingTokenizer, load_tokenizer
from svoc_torch.runtime import NativeHashingTokenizer, native
from svoc_torch.runtime.native import native_pack_tokens_raw

REPO = Path(__file__).resolve().parent.parent

ASCII = SyntheticSource(batch=64, seed=7)() + [
    "",
    "a",
    "Hello, World!  punctuation...and--dashes",
    "UPPER lower MiXeD 12345 0xdeadbeef",
    "word " * 200,  # truncation
    "trailing word",
    "   ",
    "!!!",
]
NON_ASCII = ["café crème brûlée", "naïve ÜBER straße", "日本語のテキスト 123", "emoji 🙂 ok",
             "Ελληνικά ΚΕΦΑΛΑΙΑ", "mixed ascii and ümlauts", "ÀÉÎÕÜ àéîõü"]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("vocab,pad,seq", [(50265, 1, 64), (30522, 0, 32), (1000, 1, 8), (50265, 1, 2)])
def test_native_tokenizer_equals_the_python_one_on_ascii(vocab, pad, seq):
    py = HashingTokenizer(vocab, pad_id=pad, max_len=seq)
    cc = NativeHashingTokenizer(vocab, pad_id=pad, max_len=seq)
    assert (py.pad_id, py.bos_id, py.eos_id) == (cc.pad_id, cc.bos_id, cc.eos_id)
    ids, mask = cc(ASCII, seq)
    assert ids.dtype == mask.dtype == np.int32 and ids.shape == (len(ASCII), seq)
    _equal((ids, mask), py(ASCII, seq))


def test_load_tokenizer_is_the_native_one():
    tok = load_tokenizer(50265, pad_id=1, max_len=128)
    assert isinstance(tok, NativeHashingTokenizer) and tok.max_len == 128
    assert tok(["one two three"])[1].sum() == 5  # bos + 3 words + eos


def test_native_tokenizer_equals_the_reference_library_on_non_ascii():
    """Non-ASCII bytes are word bytes with no case folding in both
    libraries, which the Python tokenizer does not do: the serving path
    runs the native ids, as the reference's does."""
    for seq in (64, 6):
        got = NativeHashingTokenizer(50265)(NON_ASCII + ASCII, seq)
        _equal(got, RefNativeTokenizer(50265)(NON_ASCII + ASCII, seq))
    assert not np.array_equal(NativeHashingTokenizer(50265)(NON_ASCII, 64)[0],
                              HashingTokenizer(50265)(NON_ASCII, 64)[0])


def _lists():
    tok = HashingTokenizer(50265, max_len=128)
    lists = strip_padding(*tok(SyntheticSource(batch=300, seed=3)(), 128))
    lists += [np.zeros(0, np.int32), np.arange(4, 400, dtype=np.int32),  # empty, over-long
              np.arange(4, 40, dtype=np.int32)]
    return lists


@pytest.mark.parametrize("rows,max_seg", [(None, 8), (16, 8), (64, 1), (None, 1), (3, 4)])
def test_native_packer_equals_pack_tokens_and_the_reference(rows, max_seg):
    lists = _lists()
    want, n_want = pack_tokens(lists, 128, max_seg, 1, rows=rows)
    got, n_got = pack_tokens_auto(lists, 128, max_seg, 1, rows=rows)
    ref, n_ref = ref_pack_tokens_auto(lists, 128, max_seg, 1, rows=rows)
    assert n_got == n_want == n_ref and type(got).__name__ == "PackedBatch"
    _equal(got, want)
    _equal(got, ref)
    assert all(a.dtype == np.int32 for a in got)
    assert fill_ratios(got)["segments_used"] == got.n_segments


def test_native_packer_refuses_what_pack_tokens_refuses():
    with pytest.raises(ValueError, match="max_segments"):
        native_pack_tokens_raw([[1, 2]], 8, 0, 1)
    with pytest.raises(ValueError, match="rows"):
        native_pack_tokens_raw([[1, 2]], 8, 2, 1, rows=0)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A missing compiler is a RuntimeError, at the tokenizer's
    construction and at the packer's call: nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="did not build"):
        NativeHashingTokenizer(50265)
    with pytest.raises(RuntimeError, match="did not build"):
        pack_tokens_auto([[2, 3]], 8, 2, 1)
    assert list(tmp_path.iterdir()) == []  # no temporary file left behind


def test_a_compiler_error_raises_with_its_report(monkeypatch, tmp_path):
    (tmp_path / "tokenizer.cpp").write_text("this is not C++\n")
    (tmp_path / "packer.cpp").write_text("")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="exit"):
        native.build()


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Three processes build into one empty directory at once: one
    library under the hashed name, no temporary file, and it loads."""
    code = (
        "import sys; from pathlib import Path; from svoc_torch.runtime import native; "
        "native.BUILD_DIR = Path(sys.argv[1]); print(native.build())"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    files = sorted(tmp_path.iterdir())
    assert [f.name for f in files] == [Path(outs[0]).name] and len(set(outs)) == 1
    assert files[0].name.startswith("libsvoc_runtime-") and files[0].suffix == ".so"
    lib = ctypes.CDLL(str(files[0]))
    assert lib.svoc_tokenize_batch and lib.svoc_pack_tokens


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for name in native.SOURCES:
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    first = native.library_path()
    assert native.library_path() == first and first.parent == native.BUILD_DIR
    (tmp_path / "packer.cpp").write_text("// edited\n")
    assert native.library_path() != first
