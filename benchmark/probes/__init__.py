"""Probes of the traced run: one module per probe, each with `install(driver)`."""
