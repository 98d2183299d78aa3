"""Core: cost model, lock machines, draw stream, simulator, sweeps."""
