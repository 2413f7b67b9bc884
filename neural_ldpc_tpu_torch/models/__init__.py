from .boosted_decoder import (
    BoostedDecoderConfig,
    BoostedNeuralDecoder,
    load_params_npz,
    params_from_numpy,
)
