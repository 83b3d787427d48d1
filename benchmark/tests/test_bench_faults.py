"""Drive whole runs of each cell on the CPU, skipping only the look for
a card, with the timed path broken underneath: `correct` has to come
out false. The faults a decode can have: an answer altered where it is
produced (one sample of the reconstruction), and half of the batch left
out (the latter half of each reconstruction's frames lost). A decode
has no state that a step could leave unchanged and, on one card, no
exchange between chips."""

import pytest
import torch

import zflac_tpu_torch.runtime.decode as rows
import zflac_tpu_torch.runtime.device as pack2
from bench_cases import CELLS, traffic
from harness import cell


def _alter(pcm):
    pcm = pcm.clone() if torch.is_tensor(pcm) else pcm.copy()
    pcm[0, 100, 0] += 1
    return pcm


def _halve(pcm):
    pcm = pcm.clone() if torch.is_tensor(pcm) else pcm.copy()
    pcm[pcm.shape[0] // 2:] = 0
    return pcm


def _break(monkeypatch, workload, fault):
    if workload.endswith(".device"):
        orig = pack2.reconstruct_pack2
        monkeypatch.setattr(pack2, "reconstruct_pack2",
                            lambda *a, **k: fault(orig(*a, **k)))
    else:
        orig = rows._run_reconstruct
        monkeypatch.setattr(rows, "_run_reconstruct",
                            lambda *a, **k: fault(orig(*a, **k)))


@pytest.mark.parametrize("fault", [_alter, _halve], ids=["altered", "halved"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    _break(monkeypatch, workload, fault)
    res, lines = cell.run_cell(workload, 31337, 0.2, False, device="cpu",
                               traffic=traffic(workload))
    # The rows engine's own MD5 check may refuse the broken PCM: then
    # every call fails instead.
    assert res["correct"] is False
    assert (res["checks"]["wrong_samples"]["value"] > 0
            or res["checks"]["failed_calls"]["value"] > 0)
    assert lines[-1].startswith("failed_calls ")
