"""Model configurations of the port: ``emapprox``, the paper's own
PV-DBOW workload (the LM architectures wait for the LM slice)."""
