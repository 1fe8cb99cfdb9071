"""Small sizes at which the benchmark's cells run on the CPU in a test:
the cell's own structure (nodes, graphs, prox, steps) at narrow widths
and short sequences."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "src"))
                if p not in sys.path]

CELLS = ("qwen3-1.7b.ring8", "whisper-large-v3.ring8",
         "qwen3-1.7b.alternating8")
#: published keys of each configuration at a test's width
CFG = {
    "qwen3-1.7b": {"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 16,
                   "intermediate_size": 128, "vocab_size": 500},
    "whisper-large-v3": {"d_model": 64, "encoder_attention_heads": 4,
                         "decoder_attention_heads": 4, "encoder_ffn_dim": 128,
                         "decoder_ffn_dim": 128, "vocab_size": 500,
                         "max_target_positions": 32},
}
#: the prox 100 times the cells' lam: at these widths a code that rounds
#: the other way in a narrow leaf moves its norms as much as the cells'
#: prox would, and the prox has to show beside it
CELL = {"seq_len": 16, "bank": 3, "traced_steps": 2,
        "compressor": {"name": "qinf", "bits": 2, "block": 16},
        "prox": {"name": "l1", "lam": 0.01}}
#: the limits at this size, set as the cells' are (``perfbench/check.py``)
#: from readings on the CPU: the widest of 64 sound seeds (1001-1048 and
#: 2**31 + 7 to 2**31 + 22) and the least of the TF32 control and of the
#: faults over 3 (2001-2003).  A code that rounds the other way in a
#: narrow leaf is a far larger share of it than at the cells' widths, so
#: most are wider than the cells'.
LIMITS = {
    "qwen3-1.7b.ring8": {"loss_gap": 2e-04, "grad_gap": 2e-05,
                         "change_gap": 1e-03, "l1_gap": 1e-04,
                         "state_gap": 1e-03, "bits_gap": 0},
    "whisper-large-v3.ring8": {"loss_gap": 4e-04, "grad_gap": 4e-05,
                               "change_gap": 8e-02, "l1_gap": 1e-03,
                               "state_gap": 7e-02, "bits_gap": 0},
    "qwen3-1.7b.alternating8": {"loss_gap": 3e-04, "grad_gap": 2e-05,
                                "change_gap": 2e-02, "l1_gap": 1e-03,
                                "state_gap": 3e-02, "bits_gap": 0},
}


def small_cell(name: str):
    """Cell ``name`` of ``BENCHMARK.json`` at the small size."""
    from perfbench import harness, traffic
    cell = harness.open_cell(name, traffic.benchmark())
    config = name.rsplit(".", 1)[0]
    cfg = {**cell.cfg, **CFG[config]}
    over = dict(CELL, frames=8) if config.startswith("whisper") else CELL
    over = dict(over, limits=LIMITS[name])
    return harness.Cell(name, cell.entry, {**cell.cell, **over}, cell.conf,
                        cfg, cell.model, cell.model.leaves(cfg))


def run(name: str, seed: int = 2 ** 31 + 7, trace: bool = False,
        faults=(), seconds: float = 0.3):
    """One CPU run of cell ``name`` at the small size, with ``faults``
    planted in the program -> (result, the lines written to standard
    error)."""
    import time
    import torch
    from perfbench import harness, readings
    torch.set_num_threads(1)
    lines = []
    result = harness.run(small_cell(name), seed, seconds, trace,
                         t_start=time.perf_counter(), device="cpu",
                         prepare=lambda tr: readings.plant(tr, faults),
                         err=lines.append)
    return result, lines
