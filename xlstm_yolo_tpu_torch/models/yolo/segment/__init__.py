"""The segment task's predictor and validator."""
