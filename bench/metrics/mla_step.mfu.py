"""The serving steps' share of the card's float32 peak (67 TFLOP/s; the
model serves in float32 with TF32 off): the model FLOPs of every prefill
and decode token of the window (``peaks_mla``: latent attention from the
program's ``mla.attended_positions``, the routed experts from its
assignments to held experts, no capacity padding) over the window's
seconds."""
from bench import peaks

UNIT = "%"
LAYER = "models.model"


def read(obs: dict):
    if not obs.get("window_s") or "model_flops" not in obs \
            or not obs.get("attended_positions"):
        return None
    return 100.0 * obs["model_flops"] / obs["window_s"] / peaks.FP32_FLOPS
