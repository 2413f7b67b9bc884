from .awgn import AWGNChannel, ChannelConfig
from .host_datagen import HostBatch, HostDatagen
from .reference_datagen import ReferenceAWGNDatagen, ReferenceNeuralDatagen
