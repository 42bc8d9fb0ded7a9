"""The multi-chip scaling harness (bench.py --scaling) must be known-good
before real multi-chip hardware exists (round-4 VERDICT #8): run the weak-
scaling sweep on the 8-device virtual CPU mesh at toy scale and check the
table it produces."""

import numpy as np


def test_scaling_sweep_on_virtual_mesh(capsys):
    import bench

    result = bench.scaling_main(
        per_chip_batch=2,
        chip_counts="1,2,4",
        n_steps=2,
        seconds=0.5,
        vocab_size=40,
        label_len=4,
        d_model=16,
        num_heads=2,
        head_dim=8,
        d_ff=32,
        num_encoder_layers=1,
        num_decoder_layers=1,
        dtype="float32",
        attn_impl="xla",
    )
    table = result["table"]
    assert [r["n_chips"] for r in table] == [1, 2, 4]
    assert all(r["audio_s_per_s_per_chip"] > 0 for r in table)
    assert table[0]["efficiency"] == 1.0
    assert all(np.isfinite(r["efficiency"]) for r in table)
    # the printed line is the one-JSON-line driver contract
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    parsed = json.loads(out)
    assert parsed["metric"] == "dp_weak_scaling_efficiency"
