from .metrics import ErrorCounts, count_errors, evaluate_ber_fer, hard_decision
from .montecarlo import CampaignConfig, MonteCarloCampaign
from .two_stage import TwoStageDecoder
