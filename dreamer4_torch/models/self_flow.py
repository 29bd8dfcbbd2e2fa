"""Self-flow distillation (counterpart of `dreamer4_tpu/models/self_flow.py`):
a shallow layer's hidden of the student, through a feedforward head,
predicts the EMA teacher's deep-layer hidden on a forward with the same
random draws."""
from __future__ import annotations

import torch
from torch import nn

from ..nn.attention import FeedForward
from ..ops.utils import cosine_distance, lens_to_mask


class SelfFlowHead(nn.Module):
    """-> the cosine distance between `student_predict_head(student)` and
    the teacher's hidden (no gradient), averaged inside `mask`."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.student_predict_head = FeedForward(dim, device=device)

    def forward(self, student_hidden, teacher_hidden, mask=None):
        pred = self.student_predict_head(student_hidden)
        if mask is not None:
            mask = mask.reshape(*mask.shape, *(1,) * (pred.ndim - 1 - mask.ndim))
        return cosine_distance(pred, teacher_hidden.detach().to(pred.dtype), mask=mask)


def self_flow_loss(model, head: SelfFlowHead, ema_params: dict, batch_kwargs: dict,
                   generator: torch.Generator, student_layer: int = -3,
                   teacher_layer: int = -1, lens=None) -> torch.Tensor:
    """The student (the model's own parameters) and the teacher (`model`
    run with `ema_params` through `torch.func.functional_call`, without
    gradient) each make one training forward of `batch_kwargs` on the same
    draws: the generator's state is taken before the student's forward and
    put back for the teacher's. Their main trunk's hiddens at
    `student_layer` and `teacher_layer` meet in `head`; `lens` masks the
    frames past each row's length. Neither forward moves a loss
    normalizer."""
    kwargs = dict(batch_kwargs, return_intermediates=True, return_layer_hiddens=True,
                  update_loss_ema=False)
    state = generator.get_state()
    student_hiddens = model(**kwargs, generator=generator)[-1]
    generator.set_state(state)
    with torch.no_grad():
        teacher_hiddens = torch.func.functional_call(
            model, ema_params, (), dict(kwargs, generator=generator))[-1]
    student_hidden = student_hiddens[student_layer]
    mask = None
    if lens is not None:
        mask = lens_to_mask(lens, student_hidden.shape[1])[:, :, None]
    return head(student_hidden, teacher_hiddens[teacher_layer], mask=mask)
