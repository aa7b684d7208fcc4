"""utils of the PyTorch port."""

from xlstm_yolo_tpu_torch.utils.logger import LOGGER, SETTINGS, SettingsManager, colorstr  # noqa: F401
