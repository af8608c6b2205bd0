# Serving runtime: the continuous batcher over the model's decode step.
