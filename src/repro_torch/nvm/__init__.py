"""``repro_torch.nvm`` — the simulated persistence tiers (numpy only,
copied from the reference package) and the persistence-backend API
subset the main path needs (``nvm-prd``, ``nvm-homogeneous``)."""
