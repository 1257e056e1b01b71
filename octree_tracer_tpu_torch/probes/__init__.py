"""The probes' Pallas gathers and adds on the card (kernels K8 and K9)."""
