"""The port's serve example mirrors (``examples/serve_ess_torch.py``,
``stream_abort_torch.py``, ``serve_cluster_torch.py``) at smoke scale on
the CPU (``--device cpu``): each runs to its end, its own assertions
included (the page gate engaged, speculative rounds, the preempted
request replayed; stream / abort / stop / priority; the cluster's
streams equal the single engine's bit for bit, its channel built from
``internode_model(H800_EP32)``), and without a card each stops unless
given ``--device cpu``.  The train mirror (``train_small_torch.py``) runs
``--tiny`` for 6 steps, then resumes from its checkpoint.  The card runs
them from ``chip_smoke.py``.
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)
import contextlib
import io
import pathlib
import runpy

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIRRORS = ["serve_ess_torch.py", "stream_abort_torch.py",
           "serve_cluster_torch.py"]


def _main(name):
    return runpy.run_path(str(ROOT / "examples" / name),
                          run_name="mirror")["main"]


@pytest.mark.parametrize("name", MIRRORS)
def test_serve_mirror_runs_on_cpu(name):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _main(name)(["--device", "cpu"])
    out = buf.getvalue()
    assert {"serve_ess_torch.py": "all requests served",
            "stream_abort_torch.py": "lifecycle OK",
            "serve_cluster_torch.py": "streams bitwise identical"}[name] \
        in out


def test_train_mirror_runs_on_cpu(tmp_path):
    """``--tiny --device cpu --steps 6``: 6 steps and a final checkpoint;
    the same command again resumes at step 6 and runs none."""
    args = ["--tiny", "--device", "cpu", "--steps", "6", "--ckpt-dir",
            str(tmp_path)]
    for expect in ("[ckpt] final checkpoint at step 6", "[resume] restored "
                   "step 6"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _main("train_small_torch.py")(args)
        out = buf.getvalue()
        assert expect in out and "done at step 6" in out, out


@pytest.mark.parametrize("name", MIRRORS + ["train_small_torch.py"])
def test_serve_mirror_needs_a_card_or_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(name)([])
