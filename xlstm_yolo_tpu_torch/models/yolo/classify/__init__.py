"""The classify task's predictor and validator."""
