"""`chip_smoke.py`'s phases at a tiny size on the CPU (the card runs them
at full size), and its refusal to report a result off the GPU."""

import json

import jax
import numpy as np
import pytest

import chip_smoke


def test_main_refuses_a_non_gpu_platform(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_sift_like_generator_is_seeded():
    a = chip_smoke.SiftLike(3).rows(50)
    b = chip_smoke.SiftLike(3).rows(50)
    assert a.shape == (50, chip_smoke.DIM) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, chip_smoke.SiftLike(4).rows(50))


def test_phase_kernels_tiny():
    chip_smoke.phase_kernels(0, q=8, n=2048, ref_queries=3, extra_n=1024)


def test_phase_build_search_and_rest_tiny(tmp_path, monkeypatch):
    from opensearch_jvector_tpu.index.reader import SegmentReader

    # tiny segments: a 4096-capacity graph tier over a 2048-capacity scan
    # tier, the same split the card sees at 2^20 / 2^18
    monkeypatch.setattr(SegmentReader, "SCAN_TIER_MAX_CODES", 2048)
    idx, queries, sc = chip_smoke.phase_build_search(
        tmp_path, 0, "cpu", n_graph=3000, n_scan=1500, n_queries=32)
    assert len(idx.segment_names) == 2
    chip_smoke.phase_rest(tmp_path, idx, queries, sc, n_requests=3)


def test_phase_on_disk_tiny(tmp_path):
    chip_smoke.phase_on_disk(tmp_path, 0, "cpu", n=2048, n_queries=32)


def test_phase_mesh_tiny(tmp_path):
    chip_smoke.phase_mesh(tmp_path, 0, "cpu", jax.devices()[:4],
                          n_per_shard=1500, n_queries=32)
