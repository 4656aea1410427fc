"""Models of the port: the dense decoder and the RoBERTa-style encoder."""
from repro_torch.models.model_zoo import Model, build_model
