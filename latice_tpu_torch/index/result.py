"""The result of one orientation query.

The port's copy of ``latice_tpu.index.result`` (the reference's
``OrientationResult``, faiss_db.py:48-89, duplicated in chroma_db.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from numpy.typing import NDArray

__all__ = ["OrientationResult"]


@dataclass
class OrientationResult:
    """Results of an orientation matching query.

    Attributes:
        query_vector: the latent vector queried.
        best_orientation: best matched orientation, zxz Euler degrees.
        candidate_orientations: the top candidates' orientations.
        distances: the similarity of each candidate.
        mean_orientation: consensus mean orientation (None without consensus).
        success: whether a consensus was found.
        similar_indices: positions (in the candidate list) of the candidates
            within the misorientation threshold.
        phase: crystal phase id of the match (multi-phase dictionaries; None
            for single-phase ones).
    """

    query_vector: NDArray[np.float64]
    best_orientation: NDArray[np.float64]
    candidate_orientations: NDArray[np.float64]
    distances: NDArray[np.float64] | None
    mean_orientation: NDArray[np.float64] | None = None
    success: bool = True
    similar_indices: NDArray[np.int64] | None = None
    phase: int | None = None

    def get_top_n_orientations(self, n: int = 5) -> NDArray[np.float64]:
        """The first ``n`` candidate orientations ordered by distance.

        Keeps the reference's order: distances sort *ascending*, although
        the stored metric is a cosine similarity.
        """
        if self.distances is None or len(self.distances) == 0:
            return self.candidate_orientations[: min(n, len(self.candidate_orientations))]
        order = np.argsort(self.distances)
        return self.candidate_orientations[order[: min(n, len(order))]]
