"""Inference (Predictor) and training: the train step, the fit loop and
checkpoints."""
