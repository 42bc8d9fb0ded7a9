from asr_chinese_e2e.core.config import Config, resolve_config


def test_three_tier_precedence():
    data = Config(lr=1e-3, batch_size=32, n_mels=80)
    model = Config(d_model=512, lr=5e-4)
    cfg = resolve_config(data, model, {"lr": 3e-4, "new_key": "x"})
    assert cfg.lr == 3e-4  # CLI wins
    assert cfg.d_model == 512  # model default present
    assert cfg.batch_size == 32  # data config survives
    assert cfg.new_key == "x"  # unknown keys are added, not rejected


def test_combine_overrides_data():
    cfg = Config(a=1).combine(Config(a=2, b=3))
    assert cfg.a == 2 and cfg.b == 3


def test_save_load_roundtrip(tmp_path):
    cfg = Config(a=1, b="x", c=[1, 2], d=0.5)
    p = str(tmp_path / "cfg.json")
    cfg.save(p)
    assert Config.load(p) == cfg
