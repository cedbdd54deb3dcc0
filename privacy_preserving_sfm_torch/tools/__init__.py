"""The port's counterparts of the repository's ``tools/`` scripts that the
reference's evaluation needs: ``synth_dataset`` (seeded rendered
datasets) and ``evaluate`` (pose parity and ATE), numpy and torch only."""
