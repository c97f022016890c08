"""Traffic drivers, one module per kind; a mix file under `mixes/` names its driver."""
