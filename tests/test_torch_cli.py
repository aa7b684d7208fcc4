"""The port's CLI and the helpers behind the facade's verbs, held against the
JAX package on the CPU.

- ``entrypoint``: ``version``, ``cfg`` and ``settings`` return JAX's values
  (the settings on tmp paths), ``checks`` its port form, ``solutions`` and
  ``track`` refuse naming their ROADMAP item; ``predict`` of
  ``vil-det-tiny`` at 160 px with ``device=cpu`` equals the facade's, also
  as ``python -m xlstm_yolo_tpu_torch.cfg``.
- ``convert_coco`` writes byte-equal label files; ``increment_path``,
  ``check_imgsz``, ``check_version`` and kin agree with JAX's.
- ``autobatch`` picks JAX's batch size from the same table of bytes.
- ``_epoch_metrics`` logs JAX's dict to a stub ``wandb``; TensorBoard's
  callback writes the epoch's scalars.
- ``Tuner._mutate`` gives JAX's children for seeds 0-3; the Ray gate and
  space are JAX's; a two-generation tune of ``vil-det-tiny`` runs, and a
  generation's error reaches ``tune_results.csv``.
"""

import csv
import json
import random
import subprocess
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import xlstm_yolo_tpu.utils as jax_utils
import xlstm_yolo_tpu_torch.utils as port_utils
from test_torch_train_loader import write_train_set
from xlstm_yolo_tpu.cfg import entrypoint as jax_entrypoint
from xlstm_yolo_tpu_torch.cfg import entrypoint
from xlstm_yolo_tpu_torch.data.imread import imwrite_png
from xlstm_yolo_tpu_torch.engine.model import YOLO

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# 1. the CLI ----------------------------------------------------------------------------------

def test_special_words_match_jax(capsys):
    assert entrypoint(["version"]) == jax_entrypoint(["version"])
    assert entrypoint(["cfg"]) == jax_entrypoint(["cfg"])
    info = entrypoint(["checks"])
    assert info == {"torch": torch.__version__, "cuda": torch.version.cuda, "backend": "cpu",
                    "devices": ["cpu"]}
    assert entrypoint([]) is None and "yolo-tpu-torch" in capsys.readouterr().out


def test_settings_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_utils, "SETTINGS", jax_utils.SettingsManager(tmp_path / "jax.json"))
    monkeypatch.setattr(port_utils, "SETTINGS", port_utils.SettingsManager(tmp_path / "port.json"))
    for words in (["settings"], ["settings", "sync=true", "runs_dir=elsewhere"], ["settings"],
                  ["settings", "reset"]):
        got, want = entrypoint(words), jax_entrypoint(words)
        assert got == want, words
        assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
            (tmp_path / "jax.json").read_text())
    assert port_utils.SettingsManager().path.parts[-2:] == ("xlstm_yolo_tpu_torch",
                                                           "settings.json")
    sm = port_utils.SettingsManager(tmp_path / "s.json")
    sm.update(sync=True)
    sm.save()
    sm2 = port_utils.SettingsManager(tmp_path / "s.json")
    assert sm2["sync"] is True
    sm2.reset()
    assert port_utils.SettingsManager(tmp_path / "s.json")["sync"] is False


def test_refusals_name_their_items(tmp_path):
    """Item 12's refusals; item 10's task training, once refused, runs from
    the command line: ``segment train`` of the tiny segment model for an
    epoch on a written polygon set."""
    from test_instance_augment import _write_seg_dataset

    with pytest.raises(NotImplementedError, match="item 12"):
        entrypoint(["solutions"])
    with pytest.raises(NotImplementedError, match="item 12"):
        YOLO("vil-det-tiny.yaml", device="cpu").track("x")
    data = _write_seg_dataset(tmp_path / "seg", n=4)
    metrics = entrypoint(["segment", "train", "model=vil-det-tiny-seg.yaml", f"data={data}",
                          "device=cpu", "imgsz=64", "batch=2", "nbs=2", "epochs=1", "workers=0",
                          "amp=False", "plots=False", f"project={tmp_path}", "name=cli"])
    assert "metrics/mAP50(M)" in metrics
    assert (tmp_path / "cli" / "weights" / "last.pt").is_file()
    with pytest.raises(NotImplementedError, match="not ported"):
        YOLO("vil-det-tiny.yaml", task="caption", device="cpu")
    for argv in (["model=vil-det-tiny.yaml"], ["detect", "predicts"]):
        with pytest.raises(ValueError):
            jax_entrypoint(argv)
        with pytest.raises(ValueError):
            entrypoint(argv)


def test_cli_predict_on_cpu(tmp_path):
    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(3)
    for j, (h, w) in enumerate([(120, 160), (150, 90)]):
        imwrite_png(src / f"im{j}.png", rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    got = entrypoint(["predict", "model=vil-det-tiny.yaml", f"source={src}", "imgsz=160",
                      "device=cpu", "conf=0.0"])
    want = YOLO("vil-det-tiny.yaml", device="cpu").predict(str(src), imgsz=160, conf=0.0)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 2
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a.boxes.data), torch.as_tensor(b.boxes.data))
    proc = subprocess.run([sys.executable, "-m", "xlstm_yolo_tpu_torch.cfg", "version"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "0.1.0" in proc.stdout, proc.stderr


# 2. converter, files, checks -----------------------------------------------------------------

def coco_json(rng) -> dict:
    images = [{"id": i, "file_name": f"dir/img{i}.jpg", "height": int(rng.integers(50, 600)),
               "width": int(rng.integers(50, 600))} for i in range(6)]
    anns = []
    for a in range(40):
        img = images[int(rng.integers(0, 5))]  # image 5 has no annotation
        x, y = rng.uniform(0, img["width"]), rng.uniform(0, img["height"])
        bw, bh = rng.uniform(0, img["width"] - x), rng.uniform(0, img["height"] - y)
        anns.append({"id": a, "image_id": img["id"], "bbox": [x, y, bw, bh],
                     "category_id": int(rng.integers(1, 91)), "iscrowd": int(a % 9 == 0)})
    anns.append({"id": 99, "image_id": 0, "bbox": [5, 5, 0, 3], "category_id": 1})  # empty box
    return {"images": images, "annotations": anns}


@pytest.mark.parametrize("cls91to80", [True, False])
def test_convert_coco_byte_equal(tmp_path, cls91to80):
    from xlstm_yolo_tpu.data import converter as jax_conv
    from xlstm_yolo_tpu_torch.data import converter

    labels = tmp_path / "annotations"
    labels.mkdir()
    rng = np.random.default_rng(4)
    for split in ("train2017", "val2017"):
        (labels / f"instances_{split}.json").write_text(json.dumps(coco_json(rng)))
    converter.convert_coco(labels, tmp_path / "port", cls91to80=cls91to80)
    jax_conv.convert_coco(labels, tmp_path / "jax", cls91to80=cls91to80)
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.txt"))
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.txt"))
    assert port_files == jax_files and len(port_files) == 12
    for f in port_files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert converter.coco91_to_coco80_class() == jax_conv.coco91_to_coco80_class()
    assert converter.coco80_to_coco91_class() == jax_conv.coco80_to_coco91_class()


def test_file_helpers_match_jax(tmp_path):
    from xlstm_yolo_tpu.utils import files as jax_files
    from xlstm_yolo_tpu_torch.utils import files

    (tmp_path / "exp").mkdir()
    (tmp_path / "exp2").mkdir()
    (tmp_path / "w.pt").write_bytes(b"x" * 3000)
    (tmp_path / "w2.pt").write_bytes(b"")
    for args in ((tmp_path / "exp",), (tmp_path / "exp", True), (tmp_path / "new",),
                 (tmp_path / "w.pt",), (tmp_path / "exp", False, "_")):
        assert files.increment_path(*args) == jax_files.increment_path(*args), args
    made = files.increment_path(tmp_path / "exp", mkdir=True)
    assert made.is_dir() and made.name == "exp3"
    for p in (tmp_path / "w.pt", tmp_path, tmp_path / "missing"):
        assert files.file_size(p) == jax_files.file_size(p)
    assert files.file_age(tmp_path / "w.pt") == jax_files.file_age(tmp_path / "w.pt") == 0
    with files.spaces_in_path(tmp_path / "w.pt") as p:
        assert p == tmp_path / "w.pt"
    with files.working_directory(tmp_path):
        assert Path.cwd() == tmp_path


def test_checks_match_jax(tmp_path):
    from xlstm_yolo_tpu.utils import checks as jax_checks
    from xlstm_yolo_tpu_torch.utils import checks

    for sz in (1, 31, 32, 33, 160, 641, [100, 200], (65, 64)):
        for stride in (32, 64):
            assert checks.check_imgsz(sz, stride) == jax_checks.check_imgsz(sz, stride)
    for cur, req in (("2.13.0+cpu", ">=2.0"), ("0.4.20", "0.4.21"), ("1.2", "==1.2.0"),
                     ("1.2.3", "!=1.2.3"), ("3.1", "<3"), ("3.1", ">3"), ("1", "<=1"),
                     ("1.0", "")):
        assert checks.check_version(cur, req) == jax_checks.check_version(cur, req), (cur, req)
    for v in ("2.13.0+cpu", "v1.2.3.4", "none"):
        assert checks.parse_version(v) == jax_checks.parse_version(v)
    assert checks.check_file(tmp_path) == jax_checks.check_file(tmp_path)
    assert checks.check_file(tmp_path / "x", hard=False) is None
    with pytest.raises(FileNotFoundError):
        checks.check_file(tmp_path / "x")
    assert checks.check_cuda_backend() == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        checks.check_cuda_backend(expect_accelerator=True)
    assert checks.check_amp("cpu") is jax_checks.check_amp() is True


# 3. autobatch --------------------------------------------------------------------------------

GIB = 1 << 30
TABLES = [
    {4: 2 * GIB, 8: 4 * GIB, 16: 8 * GIB, 32: 16 * GIB, 64: 32 * GIB},
    {4: 20 * GIB, 8: 40 * GIB},                            # nothing fits: the first
    {4: 1 * GIB, 8: -1, 16: 2 * GIB},                      # out of memory stops the climb
    {4: 1 * GIB, 8: int(12.8 * GIB), 16: int(12.8 * GIB) + 1, 32: 1 * GIB},  # exactly the limit
]


@pytest.mark.parametrize("table", TABLES)
def test_autobatch_rule_matches_jax(monkeypatch, table):
    from xlstm_yolo_tpu.utils import autobatch as jax_ab
    from xlstm_yolo_tpu_torch.utils import autobatch as ab

    monkeypatch.setattr(jax_ab, "device_memory_bytes", lambda: 16 * GIB)
    monkeypatch.setattr(jax_ab, "compiled_memory_bytes", lambda fn, *a: table[fn])
    monkeypatch.setattr(ab, "device_memory_bytes", lambda: 16 * GIB)
    monkeypatch.setattr(ab, "step_memory_bytes", lambda make_step, bs: table[bs])
    cands = tuple(table)
    peaks = {}
    got = ab.autobatch(lambda bs: None, candidates=cands, peaks=peaks)
    assert got == jax_ab.autobatch(lambda bs: (bs, ()), candidates=cands)
    assert peaks == {bs: table[bs] for bs in list(peaks)} and peaks


def test_autobatch_raises_on_cpu():
    from xlstm_yolo_tpu_torch.utils import autobatch as ab

    with pytest.raises(RuntimeError, match="CUDA"):
        ab.autobatch(lambda bs: None)


# 4. integrations -----------------------------------------------------------------------------

def test_epoch_metrics_with_stub_wandb(monkeypatch):
    from xlstm_yolo_tpu.utils.callbacks import Callbacks as JaxCallbacks
    from xlstm_yolo_tpu.utils.callbacks import integrations as jax_int
    from xlstm_yolo_tpu_torch.utils.callbacks import Callbacks
    from xlstm_yolo_tpu_torch.utils.callbacks import integrations

    logged = []
    wandb = types.ModuleType("wandb")
    wandb.run = None
    wandb.init = lambda **kw: None
    wandb.log = lambda d, step: logged.append((d, step))
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    trainer = SimpleNamespace(epoch=3, args=SimpleNamespace(project=None, name=None),
                              metrics={"metrics/mAP50(B)": 0.5, "val/box_loss": np.float32(1.25),
                                       "fitness": 7, "names": "not a number"})
    for cb_cls, module in ((Callbacks, integrations), (JaxCallbacks, jax_int)):
        cb = cb_cls()
        assert module.add_available_integrations(cb) == ["wandb"]
        cb.run("on_fit_epoch_end", trainer)
    assert logged[0] == logged[1]
    assert logged[0] == ({"epoch": 3, "metrics/mAP50_B_": 0.5, "val/box_loss": 1.25,
                          "fitness": 7.0}, 3)


def test_trainer_registers_integrations_only_with_sync(monkeypatch, tmp_path):
    from xlstm_yolo_tpu_torch.engine.trainer import DetectionTrainer

    wandb = types.ModuleType("wandb")
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    hooks = {}
    for sync in (False, True):
        monkeypatch.setitem(port_utils.SETTINGS, "sync", sync)
        t = DetectionTrainer(overrides={"project": str(tmp_path), "plots": False},
                             model_cfg="vil-det-tiny.yaml", device="cpu")
        hooks[sync] = len(t.callbacks.get("on_train_start"))
    assert hooks == {False: 0, True: 1}


def test_tensorboard_scalars(monkeypatch, tmp_path):
    from xlstm_yolo_tpu_torch.utils.callbacks import Callbacks, add_tensorboard

    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(("dir", log_dir))

        def add_scalar(self, k, v, step):
            written.append((k, v, step))

        def flush(self):
            pass

        def close(self):
            written.append("closed")

    stub = types.ModuleType("torch.utils.tensorboard")
    stub.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", stub)
    cb = Callbacks()
    assert add_tensorboard(cb, str(tmp_path))
    trainer = SimpleNamespace(epoch=2, metrics={"a": 1, "b": "x"})
    cb.run("on_fit_epoch_end", trainer)
    cb.run("on_train_end", trainer)
    assert written == [("dir", str(tmp_path)), ("a", 1.0, 2), "closed"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert add_tensorboard(Callbacks(), str(tmp_path)) is False


# 5. the tuner --------------------------------------------------------------------------------

def test_mutation_matches_jax():
    from xlstm_yolo_tpu.engine import tuner as jax_tuner
    from xlstm_yolo_tpu_torch.engine import tuner

    assert tuner.SPACE == jax_tuner.SPACE
    mid = {k: (lo + hi) / 2 for k, (lo, hi, _g) in tuner.SPACE.items()}
    partial = {"lr0": 0.01, "mosaic": 1.0, "degrees": 0.0}
    for seed in range(4):
        for parent in (mid, partial, {}):
            rng, jrng = random.Random(seed), random.Random(seed)
            p, j = dict(parent), dict(parent)
            for _ in range(3):
                p = tuner.Tuner._mutate(None, p, rng)
                j = jax_tuner.Tuner._mutate(None, j, jrng)
                assert p == j, (seed, parent)


def test_ray_gate_and_space_match_jax():
    from xlstm_yolo_tpu.engine import tuner as jax_tuner
    from xlstm_yolo_tpu_torch.engine import tuner

    assert tuner.ray_tune_space() == jax_tuner.ray_tune_space()
    assert tuner.TASK2METRIC == jax_tuner.TASK2METRIC
    with pytest.raises(ModuleNotFoundError) as e:
        tuner.run_ray_tune(object())
    with pytest.raises(ModuleNotFoundError) as je:
        jax_tuner.run_ray_tune(object())
    assert str(e.value) == str(je.value)
    with pytest.raises(ModuleNotFoundError, match="[Rr]ay"):
        YOLO("vil-det-tiny.yaml", device="cpu").tune(use_ray=True)


@pytest.fixture(scope="module")
def tune_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("tuneset")
    data = write_train_set(root, 8, seed=1, split="train")
    write_train_set(root, 4, seed=2, split="val")
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images/train",
                                    "val": "images/val", "names": [f"c{i}" for i in range(5)]}))
    return data


def test_tiny_tune(tune_set, tmp_path):
    from xlstm_yolo_tpu_torch.engine.tuner import SPACE

    y = YOLO("vil-det-tiny.yaml", device="cpu")
    best_hyp, best_fit = y.tune(data=str(tune_set), iterations=2, epochs_per_iter=1,
                                save_dir=str(tmp_path / "tune"), imgsz=160, batch=4, nbs=4,
                                workers=0, amp=False, lr0=0.01)
    assert np.isfinite(best_fit) and best_fit >= 0.0
    for k, v in best_hyp.items():
        lo, hi, _ = SPACE[k]
        assert lo <= v <= hi
    rows = (tmp_path / "tune" / "tune_results.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("gen,fitness,lr0") and "error" not in rows[0]
    assert (tmp_path / "tune" / "best_hyperparameters.yaml").exists()
    assert (tmp_path / "tune" / "gen1" / "weights" / "last.pt").exists()


def test_tune_error_reaches_the_csv(tune_set, tmp_path, monkeypatch):
    def broken(self):
        raise RuntimeError("chunkwise_fw: launch failed")

    monkeypatch.setattr("xlstm_yolo_tpu_torch.engine.trainer.DetectionTrainer.train", broken)
    y = YOLO("vil-det-tiny.yaml", device="cpu")
    best_hyp, best_fit = y.tune(data=str(tune_set), iterations=2, epochs_per_iter=1,
                                save_dir=str(tmp_path / "tune"), imgsz=160, workers=0)
    assert best_fit == 0.0
    with open(tmp_path / "tune" / "tune_results.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["gen"] for r in rows] == ["0", "1"]
    assert all(r["error"] == "RuntimeError: chunkwise_fw: launch failed" for r in rows)
