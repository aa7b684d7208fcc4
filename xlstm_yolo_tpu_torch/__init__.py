"""xlstm_yolo_tpu_torch: the PyTorch + CUDA port of xlstm_yolo_tpu for
NVIDIA Hopper (H100).

The JAX package ``xlstm_yolo_tpu`` is the reference; this package mirrors
its layout and never imports it or JAX:

- ``ops``    — the chunkwise mLSTM: plain PyTorch versions and the
               hand-written CUDA kernel (``csrc/chunkwise_fw.cu``);
- ``nn``     — ViL layers, YAML blocks, the v10 head, the graph compiler;
- ``engine`` — the ``YOLO`` facade, predictor and results;
- ``data``   — device letterbox;
- ``utils``  — anchors, box scaling, weight conversion from the JAX tree.
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy: keep `import xlstm_yolo_tpu_torch.ops` cheap
    if name == "YOLO":
        from xlstm_yolo_tpu_torch.engine.model import YOLO

        return YOLO
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["YOLO", "__version__"]
