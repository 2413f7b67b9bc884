from .protograph import CodeSpec, available_codes, get_code, load_basegraph, load_gen_matrix, nr_bg2_z16, wman_n576
from .tanner import TannerGraph
