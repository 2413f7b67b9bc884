from .boosted_decoder import (
    BoostedDecoderConfig,
    BoostedNeuralDecoder,
    load_params_npz,
    params_from_numpy,
)
from .neural_decoder import NeuralDecoderConfig, NeuralMinSumDecoder, neural_params_from_numpy
