"""FLOP and byte accounting of a step, and the roofline report."""
