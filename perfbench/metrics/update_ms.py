"""Device ms a step of the algorithm layer: lines 6-10 of Prox-LEAD's
Algorithm 1 and the prox, everything launched inside the trainer's
``_sharded_update`` (``optim/decentralized.py``, ``core/prox.py``) but
outside the exchange on the wire."""

WRAPS = [("repro_torch.optim.decentralized:"
          "DecentralizedTrainer._sharded_update", "update"),
         ("repro_torch.optim.wire:WireExchange.bucketed", "wire")]


def read(ctx):
    return ctx.trace.part_ms("update")
