"""The traffic generators, one a kind of traffic. A traffic mix
(satbench/traffic/<mix>.json) names its generator under "driver" and holds
the generator's parameters. Each module has `run(ctx)`, one run of a cell
(set-up, window, trace, check), and `control(ctx)`, the comparison's
numbers with the reference in the program's place, computed with TF32 on.
"""
