"""The pose task's predictor and validator."""
