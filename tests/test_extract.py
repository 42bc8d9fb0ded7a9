"""Archive-extractor test (round-3 VERDICT #7).

Miniature AISHELL-1-shaped fixture: an outer ``data_aishell.tgz`` holding
``data_aishell/wav/S000{1,2}.tar.gz`` (per-speaker inner tars) plus a
transcript file. Behavior contract:
``/root/reference/data/extract_aishell1.py:7-20`` — outer untar, inner
untars into ``wav/``, inner tars deleted.
"""

import io
import os
import subprocess
import sys
import tarfile

from asr_chinese_e2e.data.extract import extract_aishell1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _add_bytes(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _make_fixture(tmp_path):
    """Returns the path of a nested tgz mimicking data_aishell.tgz."""
    inner_tars = {}
    for spk in ("S0001", "S0002"):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            for split in ("train", "dev"):
                _add_bytes(
                    tf, f"{split}/{spk}/BAC009{spk}W0001.wav", b"RIFFfake"
                )
        inner_tars[spk] = buf.getvalue()

    outer = tmp_path / "data_aishell.tgz"
    with tarfile.open(outer, "w:gz") as tf:
        for spk, blob in inner_tars.items():
            _add_bytes(tf, f"data_aishell/wav/{spk}.tar.gz", blob)
        _add_bytes(
            tf,
            "data_aishell/transcript/aishell_transcript_v0.8.txt",
            "BAC009S0001W0001 你 好\n".encode("utf-8"),
        )
    return outer


def test_extract_roundtrip(tmp_path):
    outer = _make_fixture(tmp_path)
    out_dir = tmp_path / "out"
    root = extract_aishell1(str(outer), str(out_dir))

    assert root == str(out_dir / "data_aishell")
    wav = os.path.join(root, "wav")
    # inner tars extracted in place...
    for spk in ("S0001", "S0002"):
        for split in ("train", "dev"):
            assert os.path.isfile(
                os.path.join(wav, split, spk, f"BAC009{spk}W0001.wav")
            )
        # ...and deleted afterwards (extract_aishell1.py:16-19)
        assert not os.path.exists(os.path.join(wav, f"{spk}.tar.gz"))
    assert os.path.isfile(
        os.path.join(root, "transcript", "aishell_transcript_v0.8.txt")
    )


def test_extract_keep_inner(tmp_path):
    outer = _make_fixture(tmp_path)
    out_dir = tmp_path / "out"
    extract_aishell1(str(outer), str(out_dir), remove_inner=False)
    assert os.path.exists(out_dir / "data_aishell" / "wav" / "S0001.tar.gz")


def test_preprocess_cli_extract(tmp_path):
    """The ``preprocess.py extract`` subcommand drives the same path."""
    outer = _make_fixture(tmp_path)
    out_dir = tmp_path / "cli_out"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "preprocess.py"), "extract",
         "--archive", str(outer), "--out", str(out_dir)],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.isfile(
        out_dir / "data_aishell" / "wav" / "train" / "S0001"
        / "BAC009S0001W0001.wav"
    )
