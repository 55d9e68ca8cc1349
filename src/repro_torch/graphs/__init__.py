from repro_torch.graphs.generators import (GENERATORS, barabasi_albert,
                                           barabasi_albert_hub, directed_web,
                                           doc_link_graph, erdos_renyi,
                                           grid2d, random_regular, ring)

__all__ = ["GENERATORS", "barabasi_albert", "barabasi_albert_hub",
           "directed_web", "doc_link_graph", "erdos_renyi", "grid2d",
           "random_regular", "ring"]
