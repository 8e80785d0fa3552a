"""The paper's evaluation on the port (counterpart of ``benchmarks/``):
one module a figure or table, each printing the reference's CSV.

``python -m repro_torch.figures.run [--scale N] [--quick] [--device D]``
runs them all. The figures (Figs. 4-11) are analytic sweeps through
:mod:`repro_torch.dse.evaluate` (numpy); :mod:`.noc_routing` and
:mod:`.moe_dispatch` run on the device.
"""
