"""Launch configurations of the port (port of ``repro/configs``).

``poisson_pcg`` holds the paper's own workload: the solver cells of the
dry run (``GRIDS``) and the CPU test problem (``SMOKE``).  The ten LM
modules (``llama3_8b``, ``gemma3_12b``, ...; ``repro_torch.models.
registry.ARCH_IDS``) each expose ``CONFIG``, the published shape, and
``SMOKE``, a reduced config of the same family for CPU tests, exactly as
the reference has them.
"""
