"""The paper's own experiment configuration (Table II; a copy of
``repro.configs.paper``)."""
from ..core.cost import CostParams

PAPER_PARAMS = CostParams(
    lam=1.0, mu=1.0, rho=1.0, alpha=0.8, omega=5, theta=0.2, gamma=0.85
)
BATCH_SIZE = 200          # requests per batch
N_SERVERS = 600
N_ITEMS = 60              # post top-10% universe
D_MAX = 5
