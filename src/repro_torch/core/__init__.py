"""Core numerics of the port: operators, state and wire format, the PCG
iteration, exact reconstruction and the NVM-ESR backends."""
