# Copied from catch_tpu/utils/ncbi_neighbors.py.
"""NCBI Entrez client for downloading genome neighbors.

Retrying urlopen with exponential + random backoff, neighbors-table
download and parsing into Neighbor records, the separate influenza path
via the NCBI influenza FTP databases (taxids 11320/11520/11552, with
year sanity checks), rate-limited batched efetch FASTA downloads into a
tempfile, and the ``construct_fasta_for_taxid`` facade behind the CLIs'
``download:TAXID[-SEGMENT]`` datasets.  Module-global ``ncbi_api_key``
raises the request rate.  Every request goes through
``urllib.request.urlopen``, so a run needs the network; the tests and
chip_smoke.py replace that one function with canned NCBI responses.

The protocol surface (URLs, column layouts, rate limits) is fixed by
NCBI.  The efetch order of ``construct_fasta_for_taxid`` is a set's
order, which follows Python's string hashing (PYTHONHASHSEED), as in
catch_tpu.
"""

import datetime
import gzip
import logging
import random
import re
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request

logger = logging.getLogger(__name__)

# Set by the CLI's --ncbi-api-key; raises e-utils rate limits.
ncbi_api_key = None


def urlopen_with_tries(url, initial_wait=5, rand_wait_range=(1, 60),
                       max_num_tries=5):
    """urlopen with retries: wait doubles per attempt, plus a random
    component so concurrent runs drift apart instead of hammering
    NCBI's rate limiter in lockstep."""
    for attempt in range(1, max_num_tries + 1):
        try:
            logger.debug("GET %s (attempt %d)", url, attempt)
            return urllib.request.urlopen(url)
        except urllib.error.HTTPError as e:
            if attempt == max_num_tries:
                logger.critical(
                    "Giving up on %s after %d HTTP failures (last: %s)",
                    url, attempt, e)
                raise
            pause = (initial_wait << (attempt - 1)) \
                + random.randint(*rand_wait_range)
            logger.info(
                "HTTP error from NCBI (%s); retrying in %d s "
                "(attempt %d/%d)", e, pause, attempt, max_num_tries)
            time.sleep(pause)
        except Exception:
            logger.critical("Non-HTTP failure while fetching %s", url)
            raise


def ncbi_neighbors_url(taxid):
    """URL of the genome-neighbors table for a taxid."""
    params = {"taxid": taxid, "cmd": "download2"}
    if ncbi_api_key is not None:
        params["api_key"] = ncbi_api_key
    return ("https://www.ncbi.nlm.nih.gov/genomes/GenomesGroup.cgi?%s"
            % urllib.parse.urlencode(params))


def fetch_neighbors_table(taxid):
    """Yield non-empty lines of the neighbors table for a taxid."""
    logger.debug("Downloading neighbors table, taxid %d", taxid)
    resp = urlopen_with_tries(ncbi_neighbors_url(taxid))
    for line in resp.read().decode("utf-8").split("\n"):
        stripped = line.rstrip()
        if stripped:
            yield stripped


def ncbi_influenza_genomes_url(database="genomeset"):
    """URL of an NCBI influenza genomes database dump."""
    assert database in ["genomeset", "influenza_na"]
    return ("ftp://ftp.ncbi.nih.gov/genomes/INFLUENZA/" + database
            + ".dat.gz")


def fetch_influenza_genomes_table(species_name, database):
    """Yield table lines mentioning species_name (case-insensitive)."""
    logger.debug("Downloading influenza genome table for %s",
                 species_name)
    needle = species_name.lower()
    resp = urlopen_with_tries(ncbi_influenza_genomes_url(database))
    payload = gzip.GzipFile(fileobj=resp).read()
    for line in payload.decode("utf-8").split("\n"):
        stripped = line.rstrip()
        if stripped and needle in stripped.lower():
            yield stripped


def ncbi_fasta_download_url(accessions):
    """efetch URL for a batch of accessions."""
    params = {"id": ",".join(accessions), "db": "nuccore",
              "rettype": "fasta", "retmode": "text"}
    if ncbi_api_key is not None:
        params["api_key"] = ncbi_api_key
    return ("https://eutils.ncbi.nlm.nih.gov/entrez/eutils/efetch.fcgi?%s"
            % urllib.parse.urlencode(params, safe=","))


def fetch_fastas(accessions, batch_size=100, reqs_per_sec=2):
    """Download sequences into a tempfile, batched + rate-limited.

    NCBI allows 2 requests/s anonymously and ~10/s with an API key (7
    used here for margin); accessions are fetched 100 per request.
    """
    logger.debug("Downloading FASTA for %d accessions", len(accessions))
    if ncbi_api_key is not None:
        reqs_per_sec = 7
    out = tempfile.NamedTemporaryFile()
    for lo in range(0, len(accessions), batch_size):
        resp = urlopen_with_tries(
            ncbi_fasta_download_url(accessions[lo:lo + batch_size]))
        for line in resp.read().decode("utf-8").split("\n"):
            out.write((line + "\n").encode())
        time.sleep(1.0 / reqs_per_sec)
    out.seek(0)
    return out


class Neighbor:
    """Immutable record of one genome neighbor."""

    def __init__(self, acc, refseq_acc, hosts, lineage, tax_name, segment,
                 metadata={}):
        self.acc = acc
        self.refseq_acc = refseq_acc
        self.hosts = hosts
        self.lineage = lineage
        self.tax_name = tax_name
        self.segment = segment
        self.metadata = metadata

    def _fields(self):
        return [self.refseq_acc, self.hosts, self.lineage, self.tax_name,
                self.segment, self.metadata]

    def __eq__(self, other):
        return (self.acc == other.acc
                and self.refseq_acc == other.refseq_acc
                and sorted(self.hosts) == sorted(other.hosts)
                and self.lineage == other.lineage
                and self.tax_name == other.tax_name
                and self.segment == other.segment
                and self.metadata == other.metadata)

    def __repr__(self):
        return ";".join('"' + str(f) + '"'
                        for f in [self.acc] + self._fields())

    def __str__(self):
        return self.acc + " : " + ", ".join(
            '"' + str(f) + '"' for f in self._fields())


# Column layout of the neighbors table (fixed by NCBI; validated
# against the "## Columns:" header line of each download).
_NEIGHBOR_COLUMNS = ["Representative", "Neighbor", "Host",
                     "Selected lineage", "Taxonomy name", "Segment name"]


def construct_neighbors(taxid):
    """Neighbor objects for all neighbors of a taxid."""
    logger.info("Building neighbor list for taxid %d", taxid)
    neighbors = []
    saw_header = False
    for line in fetch_neighbors_table(taxid):
        if not line.strip():
            continue
        cells = line.split("\t")
        if line.startswith("##"):
            saw_header = True
            if line.startswith("## Columns:"):
                names = [c.replace('"', "") for c in cells[1:]]
                if names != _NEIGHBOR_COLUMNS:
                    raise Exception(
                        "Unexpected column layout in the NCBI neighbors "
                        "table: %r" % names)
            continue
        if not saw_header:
            logger.critical(
                "No header found in the neighbors table for taxid %s — "
                "this may not be a valid species-level taxid", taxid)
        neighbors.append(Neighbor(
            acc=cells[1], refseq_acc=cells[0],
            hosts=cells[2].split(","),
            lineage=tuple(cells[3].split(",")),
            tax_name=cells[4],
            segment=cells[5].replace("segment", "").strip()))
    return neighbors


_INFLUENZA_SPECIES = {11320: "Influenza A virus",
                      11520: "Influenza B virus",
                      11552: "Influenza C virus"}
_INFLUENZA_LINEAGES = {
    11320: ("Orthomyxoviridae", "Alphainfluenzavirus",
            "Influenza A virus"),
    11520: ("Orthomyxoviridae", "Betainfluenzavirus",
            "Influenza B virus"),
    11552: ("Orthomyxoviridae", "Gammainfluenzavirus",
            "Influenza C virus"),
}


def construct_influenza_genome_neighbors(taxid):
    """Neighbor objects for influenza genomes.

    Influenza is not in the neighbors CGI; its genomes come from the
    dedicated FTP dumps (genomeset for A/B, influenza_na for C).
    Records whose collection date parses to a future year are dropped
    as typos.
    """
    logger.info("Building influenza neighbor list for taxid %d", taxid)
    if taxid not in _INFLUENZA_SPECIES:
        raise ValueError(
            "Taxid (%d) must be for either influenza A or influenza B "
            "virus species" % taxid)
    species = _INFLUENZA_SPECIES[taxid]
    lineage = _INFLUENZA_LINEAGES[taxid]
    database = "genomeset" if taxid in (11320, 11520) else "influenza_na"
    year_re = re.compile("([1-2][0-9]{3})")
    this_year = int(datetime.datetime.now().year)

    neighbors = []
    for line in fetch_influenza_genomes_table(species, database):
        if not line.strip():
            continue
        cells = line.split("\t")
        m = year_re.search(cells[5])
        if m is None:
            continue
        year = int(m.group(1))
        if year > this_year:
            continue
        neighbors.append(Neighbor(
            acc=cells[0], refseq_acc=None, hosts=[cells[1]],
            lineage=lineage, tax_name=cells[7], segment=cells[2],
            metadata={"subtype": cells[3], "country": cells[4],
                      "year": year, "seq_len": int(cells[6])}))
    return neighbors


def construct_fasta_for_taxid(taxid, segment=None,
                              influenza_species={11320, 11520, 11552},
                              write_to=None):
    """Fetch accessions + FASTA for a taxonomy.

    Returns:
        tempfile object containing the sequences in FASTA format
    """
    if not isinstance(taxid, int):
        try:
            taxid = int(taxid)
        except ValueError as error:
            raise ValueError(
                "'%s' is not a valid NCBI taxonomic ID; it must be an "
                "integer" % taxid) from error

    logger.info("Assembling FASTA for taxid %d%s", taxid,
                "" if segment is None else (", segment %s" % segment))

    if taxid in influenza_species:
        neighbors = construct_influenza_genome_neighbors(taxid)
    else:
        neighbors = construct_neighbors(taxid)
    if not neighbors:
        raise Exception("No neighbors were found for taxid %d" % taxid)

    if segment is not None:
        neighbors = [n for n in neighbors if n.segment == segment]
        if not neighbors:
            raise Exception(
                "After filtering for segment '%s', no neighbors are "
                "left for taxid %d" % (segment, taxid))

    unique_acc = set(n.acc for n in neighbors)
    logger.info("%d neighbors (%d unique accessions)", len(neighbors),
                len(unique_acc))

    if write_to is not None:
        with open(write_to, "w") as fw:
            for acc in sorted(unique_acc):
                fw.write(str(acc) + "\n")

    return fetch_fastas(list(unique_acc))
