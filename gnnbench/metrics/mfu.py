"""Model FLOPs of the traced units (``costs/model_<app>.py``) over the
traced window, as a percent of the H100's 67 TFLOP/s fp32 peak."""
from gnnbench import readers


def read(obs):
    return readers.mfu_pct(obs)
