"""Device ms a step of the model layer: the forward pass, the loss and
the backward pass, everything launched inside the trainer's
``loss_and_grad`` (``models/transformer.py``, ``models/layers.py``)."""

WRAPS = [("repro_torch.optim.decentralized:"
          "DecentralizedTrainer.loss_and_grad", "model")]


def read(ctx):
    return ctx.trace.part_ms("model")
