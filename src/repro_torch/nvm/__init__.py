"""``repro_torch.nvm`` — the simulated persistence tiers (numpy only,
copied from the reference package), GF(2^8) Reed-Solomon arithmetic
(``gf256``), and the persistence-backend API subset the port's paths
need (``nvm-prd``, ``nvm-homogeneous``, ``erasure(...)``)."""
from repro_torch.nvm.store import TIER_SPECS  # noqa: F401
