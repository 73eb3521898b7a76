"""Post-solve analysis: vortex metrics from the streamfunction."""
