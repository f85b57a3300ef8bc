"""Launch configurations of the port (port of ``repro/configs``).

``poisson_pcg`` holds the paper's own workload: the solver cells of the
dry run (``GRIDS``) and the CPU test problem (``SMOKE``).  The
reference's ten LM configurations come with the NN stack (ROADMAP,
Queue 1, item 3).
"""
