"""Optimizers + schedules + gradient compression (PyTorch).

AdamW keeps fp32 moments; Adafactor keeps factored second moments
(~4 bytes/param total) for configs that cannot afford AdamW states.
``compressed_psum`` is the int8 chunk-quantized gradient sum over a
leading replica dimension.  Params, grads and states are dicts of
tensors; every update returns new ones.
"""
from .adamw import adamw_init, adamw_update  # noqa: F401
from .adafactor import adafactor_init, adafactor_update  # noqa: F401
from .schedule import cosine_schedule, linear_warmup  # noqa: F401
from .compress import compressed_psum, quantize_grads, dequantize_grads  # noqa: F401


def make_optimizer(name: str, lr, **kw):
    """``(init(params), update(grads, state, params, step))`` of the named
    optimizer (``"adamw"`` or ``"adafactor"``)."""
    if name == "adamw":
        return (
            lambda params: adamw_init(params),
            lambda g, s, p, step: adamw_update(g, s, p, step, lr=lr, **kw),
        )
    if name == "adafactor":
        return (
            lambda params: adafactor_init(params),
            lambda g, s, p, step: adafactor_update(g, s, p, step, lr=lr, **kw),
        )
    raise ValueError(name)
