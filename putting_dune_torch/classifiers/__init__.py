"""The classical rate learners of the rate-learner CLI, without sklearn.

sklearn 1.9's classifiers as the JAX package's `get_sklearn_classifier`
configures them, in float64 PyTorch on the tensors' device (trees read X
in float32, as sklearn's do): `preprocessing` (StandardScaler, the
two-step Pipeline), `neighbors` (KNeighborsClassifier), `tree` and
`ensemble` (DecisionTreeClassifier, RandomForestClassifier, the soft
VotingClassifier), `neural_network` (MLPClassifier), `svm` (SVC) and
`gaussian_process` (GaussianProcessClassifier). `joblib_io` reads the JAX
package's `.joblib` files and writes and reads the port's own `.npz`.
"""
