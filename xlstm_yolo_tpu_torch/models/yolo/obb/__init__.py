"""The obb task's predictor and validator."""
