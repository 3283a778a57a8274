"""MeanShift clustering wrapper: the port's copy of
``object_keypoints_tpu/utils/clustering.py`` (reference perception/utils/
clustering_utils.py:5-17). Kept for API parity; the batched alternative the
pipeline uses is ``ops.associate.masked_kmeans``. scikit-learn is imported
when a ``KeypointClustering`` is made, so importing this module needs none
(the CUDA machine has no scikit-learn)."""


class KeypointClustering:
    def __init__(self, bandwidth):
        from sklearn import cluster

        self.clustering = cluster.MeanShift(
            bandwidth=bandwidth, cluster_all=True, bin_seeding=True, min_bin_freq=1
        )
        self.past_clusters = None

    def __call__(self, indices):
        """indices: N x D array -> (cluster centers C x D, labels N)."""
        self.clustering.fit(indices)
        return self.clustering.cluster_centers_, self.clustering.labels_
