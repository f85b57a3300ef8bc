"""Recoverable solvers of the port: the :class:`RecoverableSolver`
interface, PCG, the generic ESR driver and the registry."""
