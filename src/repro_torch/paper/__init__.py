"""The paper's §5 comparisons on the port: Fig. 1 (smooth), Fig. 2
(non-smooth), Tables 2/3 (rates against theory) and the ablations, with
the rows, claims and thresholds of the JAX package's ``benchmarks/``.

    python -m repro_torch.paper [--only fig1,fig2,table3,ablations]
                                [--steps N] [--seeds S] [--device cpu]

Runs in f64 on the card unless ``--device cpu`` is given.
"""
